"""mixtral-8x22b [arXiv:2401.04088] — 8 experts top-2, SWA.  (A copy of
the JAX package's ``configs/mixtral_8x22b.py``; at 141 B parameters it
does not fit one card, so only its ``reduced`` form runs until the port
is multi-device, ROADMAP Queue 1 item 12.)"""
from repro_torch.config import ModelConfig, TConstConfig, register_arch


@register_arch("mixtral_8x22b")
def mixtral_8x22b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        arch_type="moe",
        source="[arXiv:2401.04088]",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        moe_d_ff=16384,
        vocab_size=32768,
        n_experts=8,
        n_experts_per_tok=2,
        attention_mode="sliding",
        sliding_window=4096,
        rope_theta=1_000_000.0,
        # TConst integration: 56 = 14 blocks x (h=2 + 2)
        tconst=TConstConfig(w_oh=256, w_og=256, h=2),
    )
