"""llama3-405b [arXiv:2407.21783] — dense GQA, 128k vocab.  (A copy of
the JAX package's ``configs/llama3_405b.py``; only its ``reduced`` form
runs in the port's tests.)"""
from repro_torch.config import ModelConfig, TConstConfig, register_arch


@register_arch("llama3_405b")
def llama3_405b() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        arch_type="dense",
        source="[arXiv:2407.21783]",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_ff=53248,
        vocab_size=128256,
        attention_mode="full",
        rope_theta=500_000.0,
        # TConst integration: 126 = 42 blocks x (h=1 + 2); pure full
        # attention otherwise, so long_500k REQUIRES tconst mode.
        tconst=TConstConfig(w_oh=256, w_og=256, h=1),
    )
