"""smollm-360m [hf:HuggingFaceTB/SmolLM-135M family] — llama-arch small.
(A copy of the JAX package's ``configs/smollm_360m.py``.)"""
from repro_torch.config import ModelConfig, TConstConfig, register_arch


@register_arch("smollm_360m")
def smollm_360m() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        arch_type="dense",
        source="[hf:HuggingFaceTB/SmolLM-135M]",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        attention_mode="full",
        rope_theta=10000.0,
        tie_embeddings=True,
        tconst=TConstConfig(w_oh=256, w_og=256, h=2),  # 32 = 8 x 4
    )
