"""mamba2-130m [arXiv:2405.21060] — attention-free SSD.  (A copy of the
JAX package's ``configs/mamba2_130m.py``.)"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("mamba2_130m")
def mamba2_130m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        arch_type="ssm",
        source="[arXiv:2405.21060]",
        n_layers=24,
        d_model=768,
        n_heads=1,              # attention-free; unused
        n_kv_heads=1,
        d_ff=0,                 # pure mixer layers (no separate FFN)
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=64,
        attention_mode="full",  # ignored: attention-free (DESIGN.md §4)
    )
