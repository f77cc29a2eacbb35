"""deepseek-moe-16b [arXiv:2401.06066] — 2 shared + 64 routed top-6,
fine-grained experts, first layer dense.  (A copy of the JAX package's
``configs/deepseek_moe_16b.py``: 16.4 B parameters, 32.8 GB in bf16, so
the whole model fits one 80 GB card.)"""
from repro_torch.config import ModelConfig, TConstConfig, register_arch


@register_arch("deepseek_moe_16b")
def deepseek_moe_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        arch_type="moe",
        source="[arXiv:2401.06066]",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,             # dense-layer FFN width
        moe_d_ff=1408,          # fine-grained expert width
        vocab_size=102400,
        n_experts=64,
        n_experts_per_tok=6,
        n_shared_experts=2,
        first_dense_layers=1,
        attention_mode="full",
        rope_theta=10000.0,
        tconst=TConstConfig(w_oh=256, w_og=256, h=2),  # 28 = 7 x 4
    )
