"""hymba-1.5b [arXiv:2411.13676] — parallel attention + mamba heads per
layer (hybrid).  Simplifications noted in DESIGN.md: meta-tokens omitted;
all attention layers use SWA (the original keeps 3 global layers).
(A copy of the JAX package's ``configs/hymba_1_5b.py``.)"""
from repro_torch.config import ModelConfig, TConstConfig, register_arch


@register_arch("hymba_1_5b")
def hymba_1_5b() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        arch_type="hybrid",
        source="[arXiv:2411.13676]",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        hybrid_parallel=True,
        ssm_state=16,
        ssm_head_dim=64,
        ssm_expand=1,           # parallel heads: mamba path at 1x width
        ssm_conv=4,
        ssm_chunk=64,
        attention_mode="sliding",
        sliding_window=1024,
        rope_theta=10000.0,
        tconst=TConstConfig(w_oh=256, w_og=256, h=2),  # 32 = 8 x 4
    )
