"""Configuration system of the PyTorch port (a copy of the JAX package's
``config.py``, kept separate so the port imports nothing of it).

Every model is described by a :class:`ModelConfig` dataclass.  Architecture
configs live in ``repro_torch.configs.<id>`` and register themselves under their
public ``--arch <id>`` name.  Input shapes (the four assigned workload
shapes) are described by :class:`ShapeConfig`.

The TConstFormer technique (the paper's contribution) is controlled by
``attention_mode`` + :class:`TConstConfig`.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# TConstFormer (paper) hyper-parameters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TConstConfig:
    """Hyper-parameters of the paper's periodic-state attention.

    Naming follows the paper: ``w_oh`` is the historical-context observation
    window, ``w_og`` the generation window, ``h`` the number of intermediate
    self-attention layers inside one TConst block.  One block has equivalent
    depth ``h + 2``; a model of equivalent depth ``L`` stacks
    ``L // (h + 2)`` blocks (paper §6.2.1: L=8 -> 2 blocks with h=2).

    The sync period k of the abstract (k=256 in the paper's example) is
    ``w_og``: after ``w_og`` generated tokens the context window slides and
    a linear-cost resync (cache miss) runs.
    """

    w_oh: int = 256
    w_og: int = 256
    h: int = 2

    @property
    def block_depth(self) -> int:
        return self.h + 2

    @property
    def w_total(self) -> int:
        return self.w_oh + self.w_og


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
ATTENTION_MODES = ("full", "sliding", "tconst", "tlin")


@dataclass(frozen=True)
class ModelConfig:
    # identity -------------------------------------------------------------
    name: str = "unnamed"
    arch_type: str = "dense"            # one of ARCH_TYPES
    source: str = ""                     # citation for the config

    # core transformer shape -------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4                  # GQA: kv heads <= heads
    d_ff: int = 1024
    vocab_size: int = 32000
    head_dim: int = 0                    # 0 -> d_model // n_heads

    # attention behaviour ----------------------------------------------------
    attention_mode: str = "full"         # full | sliding | tconst | tlin
    sliding_window: int = 0              # >0 enables SWA when mode != tconst
    local_global_ratio: int = 0          # gemma3: N local layers per 1 global
    rope_theta: float = 10000.0
    mrope: bool = False                  # qwen2-vl multimodal rope sections
    mrope_sections: Tuple[int, ...] = ()
    logit_softcap: float = 0.0

    # normalisation / activation ----------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE ----------------------------------------------------------------------
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                    # expert hidden dim (deepseek fine-grained)
    first_dense_layers: int = 0          # deepseek: first k layers dense
    router_aux_coef: float = 0.01

    # SSM (mamba2 / hybrid) -----------------------------------------------------
    ssm_state: int = 0                   # state dim per head (0 = no ssm)
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # hybrid (hymba): parallel attention + mamba heads in one layer
    hybrid_parallel: bool = False

    # encoder-decoder (whisper) ---------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0                 # encoder positions after conv frontend

    # modality frontend stubs ------------------------------------------------------
    frontend: str = "none"               # none | audio_stub | vision_stub
    frontend_tokens: int = 0             # patches / frames supplied by stub
    frontend_dim: int = 0                # embedding dim produced by stub

    # the paper's technique ----------------------------------------------------------
    tconst: TConstConfig = field(default_factory=TConstConfig)

    # numerics -------------------------------------------------------------------------
    dtype: str = "bfloat16"              # activation dtype
    param_dtype: str = "float32"

    # ------------------------------------------------------------------ helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def tconst_blocks(self) -> int:
        """Number of stacked TConst blocks for equivalent depth n_layers."""
        bd = self.tconst.block_depth
        return max(1, self.n_layers // bd)

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.arch_type in ARCH_TYPES, self.arch_type
        assert self.attention_mode in ATTENTION_MODES, self.attention_mode
        if not self.is_attention_free:
            assert self.n_heads % self.n_kv_heads == 0, (
                f"{self.name}: n_heads {self.n_heads} not divisible by "
                f"n_kv_heads {self.n_kv_heads}")
        if self.is_moe:
            assert 0 < self.n_experts_per_tok <= self.n_experts
        if self.attention_mode == "tconst":
            assert self.n_layers % self.tconst.block_depth == 0 or \
                self.n_layers >= self.tconst.block_depth, (
                    f"{self.name}: equivalent depth {self.n_layers} not "
                    f"compatible with block depth {self.tconst.block_depth}")


# ---------------------------------------------------------------------------
# Workload shapes (the four assigned input shapes)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str) -> Callable:
    def deco(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
        _REGISTRY[name] = fn
        return fn
    return deco


# The paper's own model, the SSM family, the dense attention LMs and the
# MoE family are ported so far; the other families are ROADMAP Queue 1
# item 9.
_ARCH_MODULES = ["tconst_41m", "mamba2_130m", "smollm_360m", "llama3_405b",
                 "gemma3_4b", "minicpm_2b", "deepseek_moe_16b",
                 "mixtral_8x22b"]


def _load_all() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, **overrides: Any) -> ModelConfig:
    """Look up an architecture config by its public ``--arch`` id."""
    if not _REGISTRY:
        _load_all()
    key = name.replace("-", "_").replace(".", "_")
    for cand in (name, key):
        if cand in _REGISTRY:
            cfg = _REGISTRY[cand]()
            if overrides:
                cfg = cfg.replace(**overrides)
            cfg.validate()
            return cfg
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


def reduced(cfg: ModelConfig, **overrides: Any) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests
    (assignment: <=2 layers equivalent scale, d_model <= 512, <= 4 experts)."""
    kw: Dict[str, Any] = dict(
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)),
        d_ff=0 if cfg.d_ff == 0 else 256,
        head_dim=0,
        vocab_size=512,
    )
    eff_mode = overrides.get("attention_mode", cfg.attention_mode)
    if eff_mode in ("tconst", "tlin"):
        kw["n_layers"] = 2 * cfg.tconst.block_depth   # 2 blocks
        kw["tconst"] = TConstConfig(w_oh=8, w_og=8, h=cfg.tconst.h)
    else:
        kw["n_layers"] = 2
    if cfg.is_moe:
        kw.update(n_experts=4, n_experts_per_tok=min(2, cfg.n_experts_per_tok),
                  moe_d_ff=64, first_dense_layers=min(1, cfg.first_dense_layers),
                  n_shared_experts=min(1, cfg.n_shared_experts))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.is_encdec:
        kw.update(encoder_layers=2, encoder_seq=16)
    if cfg.frontend != "none":
        kw.update(frontend_tokens=8, frontend_dim=32)
    if cfg.sliding_window:
        kw["sliding_window"] = 8
    if cfg.mrope:
        kw["mrope_sections"] = (8, 4, 4)   # sums to head_dim//2 = 16
    kw.update(overrides)
    out = cfg.replace(**kw)
    out.validate()
    return out
