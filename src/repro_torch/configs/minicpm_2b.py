"""minicpm-2b [arXiv:2404.06395] — llama-like; trained with the WSD
(warmup-stable-decay) schedule implemented in repro_torch.training.schedules.
(A copy of the JAX package's ``configs/minicpm_2b.py``.)"""
from repro_torch.config import ModelConfig, TConstConfig, register_arch


@register_arch("minicpm_2b")
def minicpm_2b() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        arch_type="dense",
        source="[arXiv:2404.06395]",
        n_layers=40,
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        d_ff=5760,
        vocab_size=122753,
        attention_mode="full",
        rope_theta=10000.0,
        tie_embeddings=True,
        tconst=TConstConfig(w_oh=256, w_og=256, h=2),  # 40 = 10 x 4
    )
