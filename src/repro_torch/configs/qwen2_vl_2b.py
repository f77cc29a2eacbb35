"""qwen2-vl-2b [arXiv:2409.12191] — M-RoPE, dynamic resolution.  The
ViT vision encoder is a stub; input_specs supplies patch embeddings and a
placeholder mask (DESIGN.md carve-out).
(A copy of the JAX package's ``configs/qwen2_vl_2b.py``.)"""
from repro_torch.config import ModelConfig, TConstConfig, register_arch


@register_arch("qwen2_vl_2b")
def qwen2_vl_2b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        arch_type="vlm",
        source="[arXiv:2409.12191]",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        frontend="vision_stub",
        frontend_tokens=256,     # patch embeddings per image
        frontend_dim=1280,       # ViT output width before the projector
        mrope=True,
        mrope_sections=(16, 24, 24),   # t/h/w bands; sum = head_dim//2
        attention_mode="full",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        tconst=TConstConfig(w_oh=256, w_og=256, h=2),  # 28 = 7 x 4
    )
