"""gemma3-4b [hf:google/gemma-3-1b-pt family] — 5 local : 1 global
attention pattern, 1024-token local window, 262k vocab.  (A copy of the
JAX package's ``configs/gemma3_4b.py``; at full width its head_dim 256
is past K2's limit of 128, ROADMAP Queue 2 item 3, so only its
``reduced`` form runs.)"""
from repro_torch.config import ModelConfig, TConstConfig, register_arch


@register_arch("gemma3_4b")
def gemma3_4b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        arch_type="dense",
        source="[hf:google/gemma-3-1b-pt]",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        d_ff=10240,
        vocab_size=262144,
        head_dim=256,
        attention_mode="sliding",
        sliding_window=1024,
        local_global_ratio=5,    # 5 local then 1 global, repeating
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        tconst=TConstConfig(w_oh=256, w_og=256, h=0),
    )
