"""whisper-small [arXiv:2212.04356] — enc-dec; conv frontend is a stub
(input_specs supplies post-conv frame embeddings, DESIGN.md carve-out).
(A copy of the JAX package's ``configs/whisper_small.py``.)"""
from repro_torch.config import ModelConfig, TConstConfig, register_arch


@register_arch("whisper_small")
def whisper_small() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        arch_type="audio",
        source="[arXiv:2212.04356]",
        n_layers=12,            # decoder layers
        encoder_layers=12,
        encoder_seq=1500,       # 30 s of audio after the conv frontend
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        frontend="audio_stub",
        frontend_tokens=1500,
        frontend_dim=768,
        attention_mode="full",
        sliding_window=4096,    # used by the long-decode sliding variant
        tie_embeddings=True,
        tconst=TConstConfig(w_oh=256, w_og=256, h=2),
    )
