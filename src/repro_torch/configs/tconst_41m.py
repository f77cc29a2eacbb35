"""The paper's own ~41M-parameter configuration (paper §6.2.1): GPT-2
vocab, n_embd 432, 12 heads, equivalent depth 8 = 2 TConst blocks with
internal depth H=2, observation windows W_oh = W_og = 256 (the `512-0.5`
variant).  Tied embeddings give ~39.6M parameters."""
from repro_torch.config import ModelConfig, TConstConfig, register_arch


@register_arch("tconst_41m")
def tconst_41m() -> ModelConfig:
    return ModelConfig(
        name="tconst-41m",
        arch_type="dense",
        source="[this paper, §6.2.1]",
        n_layers=8,
        d_model=432,
        n_heads=12,
        n_kv_heads=12,
        d_ff=1728,
        vocab_size=50257,
        attention_mode="tconst",
        tie_embeddings=True,
        rope_theta=10000.0,
        tconst=TConstConfig(w_oh=256, w_og=256, h=2),  # 8 = 2 x 4
    )
