#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure raises, so the exit code is non-zero):

1. Device: a CUDA device must be visible; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles every kernel source from ``src/repro_torch/csrc/*.cu``
   with ``nvcc`` for ``sm_90a`` (one process per source, in parallel) and
   times it; ``cuobjdump -sass`` must show tensor-core instructions (HMMA
   or HGMMA) in every bf16 entry of K2's forward and backward libraries
   (the backward's f32 entries, on the CUDA cores, are reported).
3. Kernels: each kernel against its plain PyTorch version on the same
   CUDA tensors, in bf16 and f32, at the shapes ``tconst-41m`` serving
   gives it.  K1 (decode, split-KV): the step's self and cross attention
   with full, partial and empty slot ranges, TLinFormer's history
   cross-attention at ``S = max_len``, a 16384-slot history (64 runs) and
   a 65536-slot one past the first version's shared-memory limit (~57.9k
   slots).  K1-int8: int8 K/V with per-vector scales at the gen-self,
   ctx-cross and hist-cross shapes.  K2 (flash):
   the resync's compress / context self / restore and the admission's
   window passes, with dead keys and negative query positions, a compress
   over a 16384-slot history (histories 12000 and 300: most key tiles
   dead) and a window pass of Lq 93 (no multiple of a query tile).  K3
   (paged decode) and K3-int8: the history over a page pool of 64-token
   pages, ragged valid lengths (0, a partial last page), window 0 and 256,
   trash entries in the table, and a row of 16000 slots (250 pages, many
   splits) beside an empty row.  K4 (the SSD scan, tiled at mamba2's
   chunk 64 with a ragged last chunk; f32 arithmetic): its two launches
   against the plain mirror of that tiling at the shapes ``mamba2-130m``
   admission gives them -- batch 4 x 1024 tokens (whole chunks), one
   prompt of 605 and of 615 tokens (10 chunks, the last ragged; 615 from
   a nonzero state) and of 29 (one short chunk), in f32 and (1024 and 605)
   with the bf16 model's inputs.  The dense LMs' shapes: K1 and K3 at
   smollm-360m's (G 3, head_dim 64: 16-byte loads; hi 600 and 935 of 999
   slots, a row with lo > 0, window 256), K1-int8 and K3-int8 at the base
   transformer's, and K2's square causal prefill of 600 and 1024 tokens
   (smollm, and 1024 under a 256 window) and of 1024 (base), where the
   library yardstick is SDPA with ``is_causal``.  deepseek-moe-16b's
   shapes (H 16 over 16 KV heads, head_dim 128): K2's prefill of 600 and
   1024 tokens (its first runs at D 128, bf16 and f32), K1 and K3 at B 2,
   S 999, hi 600 and 935, G 1; in tconst mode K2's compress (B 2, 256 x
   999) and restore (999 x 256) and K1 over the 256-slot window and
   context slots.  minicpm-2b's (36 heads over 36 KV heads, head_dim 64):
   K1 at S 999 and K2's causal prefill of 1024.  Prints the kernel's,
   the plain version's and ``F.scaled_dot_product_attention``'s times (a
   yardstick only, with the gather or dequantisation it needs; the port
   never calls it; no one PyTorch call computes K4) and the least time
   the card could take.  K2's backward (``flash_attention_bwd``) and its
   forward's row log-sum-exp, in bf16 and f32, at the shapes a
   tconst-41m train step at batch 8 x 1024 gives them: the compress
   (dead keys), the context self-attention, the restore, the generation
   window's self and cross attention and TLinFormer's history cross, a
   compress whose every query is fully masked, the base transformer's
   causal 1024, one case at G 3, D 64 with a softcap and a window, and
   deepseek-moe-16b's heads (D 128) on a causal 1024 at B 2;
   dq, dk and dv against the plain backward (TOL times max(1, max
   |plain|)), with SDPA's autograd backward as the yardstick.  Then the
   device launches one call of K1, K1-int8, K2, K3, K3-int8 and each K4
   launch makes (torch.profiler): one each, and K2, K1 and K3 at
   deepseek's shapes too; K2's backward three (delta, dk/dv, dq).
4. Serve ``tconst-41m`` at full width with the port's seeded init
   (``--sessions 4 --prompt-len 600 --gen 320 --chunk 32``), each run's
   launch counters reset before the scheduler and read right after it:
   tconst on the dense layout (the first slice's main path, bf16 and f32)
   and, in bf16 and f32, TLinFormer on the paged and paged_int8 layouts
   (3 slots, a pool of 31 pages of 64 below the full 48, so an admission
   waits for pages a finished session frees while two sessions decode)
   and tconst on the int8 layout.  Each run must launch exactly its
   kernels (K3 on the paged runs, K1-int8 on the int8 runs) and no plain
   version.  f32 greedy streams must equal their solo runs on the same
   layout (the f32 runs of the new layouts use ``--prompt-len 700 --gen
   96``: every session still crosses a resync).  bf16 logits after the
   prefill and after a few decode steps are held against the f32 plain
   path on the CPU, same layout.  mamba2-130m's f32 run (streams only)
   is cut to 6 of its 24 layers.  Then the dense attention LMs at full
   width: smollm-360m (32 layers, d 960, 15 heads over 5 KV heads) on
   the dense layout (K1, K2) and the paged one (K2, K3), and the paper's
   base transformer (tconst-41m in full attention, on the tconst
   weights) on int8 (K1-int8, K2) and paged_int8 (K2, K3-int8), same
   argv, bf16 and f32 (f32 at ``--prompt-len 700 --gen 72``, smollm at 8
   of its 32 layers); their bf16 logits held at 3x the CPU plain path's
   own bf16 error.  Then the MoE
   family: deepseek-moe-16b (16.4 B parameters, drawn on the card in bf16
   from a seed) at full width and depth on dense (K1, K2) and paged (K2,
   K3, the under-sized pool) in bf16 (``--gen 96``; finite logits), and
   at full width and depth 3 (the dense layer and two MoE layers) in f32
   (streams equal their solo runs); at that depth its f32 and bf16 logits
   are held against one CPU f32 reference, with the count of routed
   tokens whose expert set differs.  Then deepseek-moe-16b in tconst mode
   (MoE FFNs inside the TConst core: 7 blocks of depth 4, 16.9 B
   parameters) on dense (K1, K2): bf16 at full width and depth, f32 at 8
   layers (2 blocks), both at ``--prompt-len 700 --gen 96`` so every
   session crosses a resync; f32 streams equal their solo runs, both
   dtypes' logits at 8 layers against one CPU f32 reference.  Prints one
   bf16 slot's KV bytes at max_len for tconst, the base, smollm and
   deepseek (LM and tconst mode).
   A window phase serves reduced gemma3 (6 layers: 5 local : 1 global),
   tconst-41m in sliding mode (window 8, 8 layers) and reduced mixtral
   (window 8, two MoE layers, G 4) on all four layouts in f32: K1 with
   ``lo > 0`` and K3 with ``window > 0`` through a model; and reduced
   deepseek in tconst mode, mixtral in tlin mode (MoE FFNs in the TConst
   core, W 8: resyncs inside the logit checks) and minicpm-2b the same
   way.  The card's logits against the CPU plain path's, the streams
   equal on the float layouts.
5. Training (``launch.train``, ``--batch 8 --seq 1024 --steps 6``):
   tconst-41m at full width in bf16 in modes tconst, tlin and full (the
   base transformer) on one seeded init, in turns A B C C B A over the
   same synthetic batches.  Each run must launch K2's forward and
   backward kernels and nothing else, no plain version, and its finite
   loss must fall; it records warm step ms, tok/s and peak device
   memory, and the first run of each mode one profiled step (device
   launches, device ms, K2 calls).  Then loss and gradients at full
   width, B 1 x 512, on the card against the CPU plain path on the same
   f32 params: f32 within a relative L2 error of 1e-4, bf16 within 3x
   the CPU plain path's own bf16 error.
6. Uniform-batch Engine (``--batch 4 --prompt-len 1024 --gen 800``): the
   paper's three variants on one set of weights -- tconst/dense,
   tlin/paged and the base transformer (full/dense) -- in one call, in
   turns (A, B, C, C, B, A): the mean cache-hit step (O(1) against O(N))
   and resync times of each run.
7. Prints the per-kernel JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.  Details go to
   ``build/chip_smoke.json``.

Numbers are device times from CUDA events (warm medians); a time is only
meaningful next to the card name and power limit printed with it.
"""
from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "build"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per type
TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # max |kernel - plain|, O(1) data
# K4 sums up to Q * N = 8192 products per output, in another order than
# the plain version, on outputs that grow with Q and N: its f32 tolerance
# is TOL relative to the output's scale, max(1, max |plain|)
# logits of the card path against the CPU f32 plain path: bf16 is about 3x
# the worst error seen (0.024 with logits of std ~0.42); f32 is far above
# its error (3e-6) yet far below any wrong attention
LOGIT_TOL = {"float32": 2e-3, "bfloat16": 0.075}
LOGIT_STEPS = 8      # decode steps checked after the prefill (K1's path)
# mamba2-130m's bf16 logits against the CPU f32 plain path: 3x the CPU
# plain path's own bf16-against-f32 error on the same two prompts (0.159
# first token, 0.184 over 8 steps: tools/torch_logit_err.py); 24 layers of
# bf16 activations, untied head
LOGIT_TOL_SSM = {"bfloat16": 0.55}

# the dense attention LMs' bf16 logits against the CPU f32 plain path: 3x
# the CPU plain path's own bf16-against-f32 error on the same two prompts
# (tools/torch_logit_err.py --arch smollm-360m, and --arch tconst-41m
# --mode full for the base transformer, on the GPU machine's CPU)
LOGIT_TOL_LM = {"smollm": {"bfloat16": 0.16},   # 0.046 first, 0.053 steps
                "full": {"bfloat16": 0.09}}     # 0.027 first, 0.030 steps
# deepseek-moe-16b's logits, at the checked depth (the dense layer and two
# MoE layers, full width): bf16 3x the CPU plain path's own bf16-against-
# f32 error on the same two prompts (tools/torch_logit_err.py --arch
# deepseek_moe_16b --layers 3, on the GPU machine's CPU: 0.057 first token,
# 0.419 over 8 steps).  It is ~0.05 where no expert set differs and 0.25-
# 0.42 at a step where one token's set flips under bf16 (186 of 2442
# routed tokens there, nearly all in the admissions); f32 as LOGIT_TOL
LOGIT_TOL_MOE = {"bfloat16": 1.26, "float32": LOGIT_TOL["float32"]}

SESSIONS_ARGS = ["--sessions", "4", "--slots", "2", "--prompt-len", "600",
                 "--gen", "320", "--chunk", "32"]
SSM = "mamba2_130m"
SMOLLM = "smollm-360m"
DEEPSEEK = "deepseek_moe_16b"
MINICPM = "minicpm_2b"
# deepseek's f32 runs and its logit checks: the dense layer and two MoE
# layers at full width (the only cut: 16.4 B parameters are 65.6 GB in
# f32, and the CPU reference reads every expert's weights each step)
DEEPSEEK_CHECK_DEPTH = 3
# deepseek's bf16 runs at full depth: gen 96 (three chunks), so each
# session but the last decodes while the next is admitted, and the paged
# run's third session waits for pages (12 + 12 of 31 held)
DEEPSEEK_BF16_ARGS = ["--gen", "96"]
# deepseek in tconst mode (MoE FFNs inside the TConst core: 7 blocks of
# depth 4, every layer MoE): bf16 at full depth; f32, its streams and both
# dtypes' logits at 2 blocks (8 layers: a restore feeds the next block;
# 20.5 GB of f32 weights), with F32_ARGS in both dtypes, so every session
# crosses a resync
DEEPSEEK_TCONST_CHECK_DEPTH = 8
# a run's model: mode -> (arch, config overrides).  "full" is the paper's
# base transformer: tconst-41m's config and weights in full attention
MODELS = {"tconst": ("tconst-41m", {"attention_mode": "tconst"}),
          "tlin": ("tconst-41m", {"attention_mode": "tlin"}),
          "full": ("tconst-41m", {"attention_mode": "full"}),
          "smollm": (SMOLLM, {}),
          "mamba2": (SSM, {}),
          "deepseek": (DEEPSEEK, {}),
          "deepseek-tconst": (DEEPSEEK, {"attention_mode": "tconst"})}
# the TConst core's attention modes, and the runs with a periodic resync
TCONST_MODES = ("tconst", "tlin")
RESYNCING = TCONST_MODES + ("deepseek-tconst",)
# the MoE runs: bf16 at full depth (finite logits), f32 at a cut depth
# whose logits both dtypes hold against one CPU f32 reference
MOE_MODES = ("deepseek", "deepseek-tconst")
# paged runs: 3 slots, a pool below the full 3 x 16 pages: sessions need
# 15, 15, 16, 16 pages of 64 (prompt + gen + one chunk), so two decode
# together and the third waits for pages with a slot free
PAGED_ARGS = ["--slots", "3", "--page-size", "64", "--pool-pages", "31"]
# f32 runs of the new layouts: shorter, every session still crosses a
# resync (g0 = 188..203 of W_og = 256); paged pool 27 of 3 x 14 pages
F32_ARGS = ["--prompt-len", "700", "--gen", "96"]
F32_PAGED_ARGS = ["--slots", "3", "--page-size", "64", "--pool-pages", "27"]
# f32 runs of the dense LMs (no resync to cross): gen 72, the shortest at
# which the first session still decodes when the third arrives, so the
# paged pool of 27 makes it wait (13 + 13 pages held)
F32_LM_ARGS = ["--prompt-len", "700", "--gen", "72"]
# gen 800 from a 1024-token prompt: four resyncs, three of them warm
ENGINE_ARGS = ["--arch", "tconst-41m", "--batch", "4", "--prompt-len",
               "1024", "--gen", "800"]
ENGINE_TURNS = (("tconst", "dense"), ("tlin", "paged"), ("full", "dense"))
# mamba2: K4 at Q = 64 on admission, 255 warm steps
SSM_ENGINE_ARGS = ["--arch", SSM, "--batch", "4", "--prompt-len", "1024",
                   "--gen", "256"]

K1, K1_INT8, K2 = "decode_attention", "decode_attention_int8", \
    "flash_attention"
K3, K3_INT8 = "paged_decode_attention", "paged_decode_attention_int8"
K2_BWD = "flash_attention_bwd"
K4_INTRA, K4_SCAN = "ssd_intra_chunk", "ssd_chunk_scan"
# (mode, layout, the kernels the run launches -- and no other); mode
# "mamba2" is the SSM family (arch mamba2_130m, no attention mode)
SESSION_RUNS = [
    ("tconst", "dense", (K1, K2)),
    ("tlin", "paged", (K1, K2, K3)),
    ("tlin", "paged_int8", (K1_INT8, K2, K3_INT8)),
    ("tconst", "int8", (K1_INT8, K2)),
    ("mamba2", "dense", (K4_INTRA, K4_SCAN)),
    # the dense attention LMs: K2 at admission, the layout's decode kernel
    # at every step
    ("smollm", "dense", (K1, K2)),
    ("smollm", "paged", (K2, K3)),
    ("full", "int8", (K1_INT8, K2)),
    ("full", "paged_int8", (K2, K3_INT8)),
    # the MoE family: deepseek-moe-16b at full width, bf16 at full depth
    # and f32 at DEEPSEEK_CHECK_DEPTH (routing and expert GEMMs PyTorch)
    ("deepseek", "dense", (K1, K2)),
    ("deepseek", "paged", (K2, K3)),
    # deepseek-moe-16b in tconst mode: the O(1) cache, K1 over the window
    # and context slots, K2 in the resync and the admission
    ("deepseek-tconst", "dense", (K1, K2)),
]
# config overrides of a run by (mode, dtype).  The f32 runs of mamba2 and
# smollm check greedy streams against their solo runs only (their logits
# are checked in bf16 at full depth): they run at a cut depth, the same
# layers and kernels (mamba2 6 of 24 layers, smollm 8 of 32)
SSM_F32_DEPTH = 6
SMOLLM_F32_DEPTH = 8
RUN_OVERRIDES = {("deepseek", "float32"): {"n_layers": DEEPSEEK_CHECK_DEPTH},
                 ("deepseek-tconst", "float32"): {
                     "n_layers": DEEPSEEK_TCONST_CHECK_DEPTH},
                 ("mamba2", "float32"): {"n_layers": SSM_F32_DEPTH},
                 ("smollm", "float32"): {"n_layers": SMOLLM_F32_DEPTH}}
# the window phase (f32, reduced widths): gemma3's 5 local : 1 global
# pattern needs 6 layers (reduced() keeps 2), window 8; tconst-41m in
# sliding mode, window 8 on every layer; mixtral (reduced: window 8, two
# MoE layers).  Every layout; streams against the CPU plain path's.
WINDOW_MODELS = {"gemma3": ("gemma3_4b", {"n_layers": 6}),
                 "sliding": ("tconst-41m", {"attention_mode": "sliding",
                                            "sliding_window": 8,
                                            "n_layers": 8}),
                 # an MoE model (top-2 of 4 experts, G 4) on windows
                 "mixtral": ("mixtral_8x22b", {}),
                 # MoE FFNs inside the TConst core (reduced: 2 blocks, W 8)
                 "deepseek-tconst": ("deepseek_moe_16b",
                                     {"attention_mode": "tconst"}),
                 "mixtral-tlin": ("mixtral_8x22b",
                                  {"attention_mode": "tlin"}),
                 # minicpm-2b (G 1, tied head), reduced
                 "minicpm": (MINICPM, {})}
WINDOW_ARGS = ["--reduced", "--dtype", "float32", "--sessions", "3",
               "--slots", "2", "--prompt-len", "20", "--gen", "24",
               "--chunk", "4", "--page-size", "16"]
LAYOUT_KERNELS = {"dense": (K1, K2), "int8": (K1_INT8, K2),
                  "paged": (K2, K3), "paged_int8": (K2, K3_INT8)}
# the kernels line: kernel -> (representative case, source, TPU kernel,
# the session run whose counts are its launches)
KERNELS = {
    K1: ("self_full", "src/repro_torch/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention.py:108", ("tconst", "dense")),
    K1_INT8: ("int8_gen_self", "src/repro_torch/csrc/decode_attention.cu",
              "src/repro/kernels/decode_attention.py:108",
              ("tlin", "paged_int8")),
    K2: ("compress", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:116", ("tconst", "dense")),
    K3: ("hist_ragged", "src/repro_torch/csrc/paged_decode_attention.cu",
         "src/repro/kernels/paged_decode_attention.py:156",
         ("tlin", "paged")),
    K3_INT8: ("hist_ragged",
              "src/repro_torch/csrc/paged_decode_attention.cu",
              "src/repro/kernels/paged_decode_attention.py:156",
              ("tlin", "paged_int8")),
    K4_INTRA: ("q64_b4", "src/repro_torch/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd_scan.py:61", ("mamba2", "dense")),
    K4_SCAN: ("q64_b4", "src/repro_torch/csrc/ssd_scan.cu",
              "src/repro/kernels/ssd_scan.py:114", ("mamba2", "dense")),
    # launches: the first tconst training run (TRAIN_TURNS)
    K2_BWD: ("compress", "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/xla_flash.py:125", ("train", "tconst")),
}

# training (phase 5): tconst-41m at full width in bf16, batch 8 x 1024,
# in modes tconst, tlin and full (the base transformer) on one seeded
# init, in turns A B C C B A, each run TRAIN_STEPS steps of AdamW (lr
# 3e-3, the launcher's cosine schedule) over the same synthetic batches
TRAIN_STEPS = 6
TRAIN_ARGS = ["--arch", "tconst-41m", "--batch", "8", "--seq", "1024",
              "--steps", str(TRAIN_STEPS), "--log-every", "1"]
TRAIN_TURNS = ("tconst", "tlin", "full")
# the gradient checks: loss and gradients at full width, B 1 x 512 (two
# windows), on the card against the CPU plain path on the same f32
# params.  Error: the relative L2 norm of the gradient difference over
# all leaves.  f32: both sides exact f32 in other summation orders; a
# wrong attention gradient is O(1).  bf16: 3x the CPU plain path's own
# bf16 error against the same f32 reference, as the logit checks
GRAD_CHECK_SHAPE = (1, 512)
GRAD_TOL_F32 = 1e-4
GRAD_BF16_FACTOR = 3.0


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median device time of one call, from CUDA events.  Each round
    queues ``reps`` calls behind a sleep kernel, so the device runs them
    back to back and host launch gaps are not measured."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return statistics.median(per)


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def k1_cases(torch, cfg, dev, max_len: int):
    """(label, B, S, lo, hi) at the decode step's shapes: B = slots."""
    W = cfg.tconst.w_og
    t = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa
    return [
        ("self_full", 2, W, t([0, 0]), t([W, W])),
        ("self_partial", 2, W, t([0, 0]), t([89, 170])),
        ("cross_partial", 2, cfg.tconst.w_oh, t([156, 0]),
         t([cfg.tconst.w_oh, cfg.tconst.w_oh])),
        ("empty", 2, W, t([0, W]), t([0, W])),
        # TLinFormer's history cross-attention on the dense layout
        ("hist_cross", 3, max_len, t([0, 0, 0]), t([0, 613, 960])),
        # long histories: 64 runs of 256 slots; 64 runs of 1024 slots past
        # the ~57.9k slots the first version's scores could hold
        ("hist_long", 2, 16384, t([0, 0]), t([16000, 9000])),
        ("hist_huge", 1, 65536, t([0]), t([65000])),
    ]


def k1_int8_cases(torch, cfg, dev, max_len: int):
    """(label, B, S, lo, hi): the int8 layouts' gen-window self, ctx
    cross and tlin history cross attention, B = slots."""
    W, Wh = cfg.tconst.w_og, cfg.tconst.w_oh
    t = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa
    return [
        ("int8_gen_self", 3, W, t([0, 0, 0]), t([89, 170, W])),
        ("int8_ctx_cross", 3, Wh, t([156, 0, Wh]), t([Wh, Wh, Wh])),
        ("int8_hist_cross", 3, max_len, t([0, 0, 0]), t([0, 613, 960])),
    ]


def k3_cases(max_len: int):
    """(label, valid_len per slot, window, row capacity in slots): the
    paged history of 3 slots at max_len, pages of 64: an empty row, a
    partial last page, a long row; window 0 (tlin) and 256.  Then a row of
    16000 slots (250 pages: many splits) beside an empty row."""
    return [("hist_ragged", [0, 613, min(960, max_len)], 0, max_len),
            ("hist_window", [0, 613, min(960, max_len)], 256, max_len),
            ("hist_long", [16000, 0], 0, 16000),
            ("hist_long_window", [16000, 0], 256, 16000)]


def k2_cases(torch, cfg, dev, max_len: int):
    """(label, q_pos, k_pos, causal) at the resync / admission shapes."""
    from repro_torch.kernels.flash_attention import INVALID_POS
    W = cfg.tconst.w_oh

    def history(lens, n):
        """Key positions of a history buffer of n slots holding lens[b]
        tokens (the rest dead), and the compress queries' tail positions
        (negative for a short history)."""
        hist_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
        pos = pos.expand(len(lens), n)
        kp = torch.where(pos < hist_len[:, None], pos,
                         torch.full_like(pos, INVALID_POS))
        tail = hist_len[:, None] - W + torch.arange(W, dtype=torch.int32,
                                                    device=dev)[None]
        return pos, kp, tail

    pos, hist_kp, tail = history([512, 100], max_len)
    tail_kp = torch.where(tail >= 0, tail, torch.full_like(tail, INVALID_POS))
    _, long_kp, long_tail = history([12000, 300], 16384)
    g0 = 88
    gen = 512 + torch.arange(g0, dtype=torch.int32, device=dev)[None]
    gen93 = 512 + torch.arange(93, dtype=torch.int32, device=dev)[None]
    ctx_kp = torch.zeros((1, W), dtype=torch.int32, device=dev)
    return [
        # resync of two rows (one with a short history: negative tail
        # positions, so fully masked compress queries)
        ("compress", tail, hist_kp, True),
        ("ctx_self", tail, tail_kp, True),
        ("restore", pos, tail_kp, True),
        # admission window pass of a 600-token prompt (g0 = 88)
        ("window_self", gen, gen, True),
        ("window_cross", gen, ctx_kp, False),
        # a compress over a long history buffer (histories 12000 and 300
        # of 16384 slots: most key tiles dead)
        ("compress_long", long_tail, long_kp, True),
        # a 605-token prompt's window pass: Lq 93, no multiple of a tile
        ("window_self_93", gen93, gen93, True),
    ]


def sdpa_k1(torch, q, k, v, lo, hi, k_scale=None, v_scale=None):
    """SDPA over the dense K/V (int8: dequantised in the timed call)."""
    import torch.nn.functional as F
    S = k.shape[1]
    slot = torch.arange(S, device=q.device)[None]
    mask = ((slot >= lo[:, None]) & (slot < hi[:, None]))[:, None, None]
    qt = q[:, :, None]

    def fn():
        kk, vv = k, v
        if k_scale is not None:
            kk = (k.float() * k_scale).to(q.dtype)
            vv = (v.float() * v_scale).to(q.dtype)
        return F.scaled_dot_product_attention(
            qt, kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask,
            enable_gqa=True)
    return fn


def sdpa_k3(torch, q, pk, pv, pt, lo, hi, k_scale=None, v_scale=None):
    """SDPA over the rows' gathered pages (gather, and int8: dequantise,
    in the timed call)."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_decode_attention import gather_pages
    S = pt.shape[1] * pk.shape[1]
    slot = torch.arange(S, device=q.device)[None]
    mask = ((slot >= lo[:, None]) & (slot < hi[:, None]))[:, None, None]
    qt = q[:, :, None]

    def fn():
        k, v = gather_pages(pk, pt), gather_pages(pv, pt)
        if k_scale is not None:
            k = (k.float() * gather_pages(k_scale, pt)).to(q.dtype)
            v = (v.float() * gather_pages(v_scale, pt)).to(q.dtype)
        return F.scaled_dot_product_attention(
            qt, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True)
    return fn


def sdpa_k2(torch, q, k, v, mask, square_causal=False):
    """SDPA with the boolean mask, or (a square causal prompt) with
    ``is_causal`` and no mask, which lets it take its fused kernels."""
    import torch.nn.functional as F
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if square_causal:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    m = mask[:, None]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=m, enable_gqa=True)


def int8_codes(torch, gen, shape, dev):
    return torch.randint(-127, 128, shape, generator=gen, device=dev,
                         dtype=torch.int32).to(torch.int8)


def paged_pool(torch, randn, gen, B, KV, D, page, pps, valid_len, dtype,
               dev):
    """A full pool of B x pps pages (+ trash) with a shuffled table whose
    entries past each row's valid length point at the trash page; int8
    (``dtype`` None) with per-vector scales."""
    P = B * pps
    shape = (P + 1, page, KV, D)
    if dtype is None:
        pk = int8_codes(torch, gen, shape, dev)
        pv = int8_codes(torch, gen, shape, dev)
        ks = randn(shape[:3] + (1,), torch.float32).abs() * 0.02 + 1e-3
        vs = randn(shape[:3] + (1,), torch.float32).abs() * 0.02 + 1e-3
    else:
        pk, pv = randn(shape, dtype), randn(shape, dtype)
        ks = vs = None
    pt = torch.randperm(P, generator=torch.Generator().manual_seed(P)).to(
        dev, torch.int32).reshape(B, pps)
    for b, n in enumerate(valid_len):
        pt[b, -(-n // page):] = P
    vl = torch.tensor(valid_len, dtype=torch.int32, device=dev)
    return pk, pv, ks, vs, pt, vl


def kernel_row(rows, kernel, case, dname, shape, out, ref, run, plain,
               library, n_bytes, flops, scale=1.0, plain_reps=20,
               tol_dtype=None, ops_dtype=None):
    """Check one kernel output against its plain version (tolerance TOL
    of ``tol_dtype``, default ``dname``, times ``scale``) and time the
    kernel, the plain version (``plain_reps`` calls a round: fewer for a
    slow host loop) and the library call (None: there is none).  The
    operations bound takes the peak rate of ``ops_dtype`` (default
    ``dname``): the type the kernel computes in."""
    import torch
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[tol_dtype or dname] * scale
    check(bool(torch.isfinite(out.float()).all()),
          f"{kernel} {case}/{dname}: non-finite output")
    check(err <= tol, f"{kernel} {case}/{dname}: max |kernel - "
          f"plain| = {err} > {tol}")
    ops_dtype = ops_dtype or dname
    b, by = bound_ms(n_bytes, flops, ops_dtype)
    rows.append({"kernel": kernel, "case": case, "dtype": dname,
                 "shape": shape, "max_abs_err": err, "tol": tol,
                 "ms": time_ms(run),
                 "plain_ms": time_ms(plain, reps=plain_reps),
                 "library_ms": None if library is None else
                 time_ms(library), "bound_ms": b, "bound_by": by,
                 "bytes_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
                 "ops_ms": 1e3 * flops / PEAK_FLOPS[ops_dtype]})


def ssd_cases():
    """(label, B, L, init, dtype): K4 at mamba2-130m's admission shapes,
    tiled at its ssm_chunk (64) -- the engine's batch of 1024-token
    prompts (whole chunks), the sessions' prompts of 605 and 615 tokens
    (10 chunks, the last ragged: 29 and 39 rows; the 615 case starts from
    a nonzero state) and a 29-token prompt (one short chunk); in f32 and,
    for the two served shapes, in bf16 (the bf16 model's inputs)."""
    return [("q64_b4", 4, 1024, False, "float32"),
            ("l605", 1, 605, False, "float32"),
            ("l615", 1, 615, True, "float32"),
            ("l29", 1, 29, False, "float32"),
            ("q64_b4", 4, 1024, False, "bfloat16"),
            ("l605", 1, 605, False, "bfloat16")]


def ssd_flops(B: int, L: int, H: int, P: int, N: int, Q: int):
    """f32 operations (an FMA is two) each K4 launch needs on these
    shapes, chunk by chunk (the last one ragged): launch 1 the scores
    C . B^T once per (row, chunk) on the s <= l pairs, and per head the
    decay, scores . xdt and the chunk-end state; launch 2 C . prev, its
    scale and add, and the state update."""
    intra = scan = 0
    for r0 in range(0, L, Q):
        q = min(Q, L - r0)
        pairs = q * (q + 1) // 2
        intra += 2 * B * pairs * N +             B * H * (pairs + 2 * pairs * P + 2 * q * P * N)
        scan += B * H * (2 * q * P * N + 2 * q * P + 2 * P * N)
    return intra, scan


def ssd_phase(torch, rows, dev, gen):
    """K4's two launches against the plain mirror of their ragged tiling,
    each on the mirror's inputs: x, b and c sliced from one conv output as
    the mixer slices them, dt = softplus, a = -(1..H)."""
    from repro_torch.config import get_config
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.layers.ssm import ssm_dims
    cfg = get_config(SSM)
    dims = ssm_dims(cfg)
    H, P, N, Q = dims.n_heads, dims.head_dim, dims.n_state, cfg.ssm_chunk

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for label, B, L, init, dname in ssd_cases():
        dtype = getattr(torch, dname)
        xbc = randn(B, L, H * P + 2 * N).to(dtype)
        x = xbc[..., :H * P].reshape(B, L, H, P)
        b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dt = torch.nn.functional.softplus(randn(B, L, H) - 4.0)
        a = -torch.arange(1, H + 1, device=dev, dtype=torch.float32)
        nc = -(-L // Q)
        shape = f"B={B} L={L} H={H} nc={nc} Q={Q} P={P} N={N}"
        f_intra, f_scan = ssd_flops(B, L, H, P, N, Q)
        # each row checks both outputs of its launch (flattened together)
        y, st = SS.ssd_intra_chunk_cuda(x, dt, a, b, c, Q)
        yr, sr = SS.ssd_intra_chunk_tiled_plain(x, dt, a, b, c, Q)
        out, ref = torch.cat([y.flatten(), st.flatten()]), \
            torch.cat([yr.flatten(), sr.flatten()])
        # launch 1's outputs are f32 whatever the inputs: the f32 TOL
        kernel_row(rows, K4_INTRA, label, dname, shape, out, ref,
                   lambda: SS.ssd_intra_chunk_cuda(x, dt, a, b, c, Q),
                   lambda: SS.ssd_intra_chunk_tiled_plain(x, dt, a, b, c, Q),
                   None, nbytes(x, dt, a, b, c, y, st), f_intra,
                   scale=max(1.0, ref.abs().max().item()),
                   tol_dtype="float32", ops_dtype="float32", plain_reps=5)
        s0 = randn(B, H, P, N) if init else None
        y2, f = SS.ssd_chunk_scan_cuda(yr, sr, dt, a, c, Q, s0)
        y2r, fr = SS.ssd_chunk_scan_tiled_plain(yr, sr, dt, a, c, Q, s0,
                                                dtype)
        check(y2.dtype == dtype, f"{K4_SCAN} {label}: y in {y2.dtype}")
        out, ref = torch.cat([y2.float().flatten(), f.flatten()]), \
            torch.cat([y2r.float().flatten(), fr.flatten()])
        kernel_row(rows, K4_SCAN, label, dname,
                   shape + (" init" if init else ""), out, ref,
                   lambda: SS.ssd_chunk_scan_cuda(yr, sr, dt, a, c, Q, s0),
                   lambda: SS.ssd_chunk_scan_tiled_plain(yr, sr, dt, a, c, Q,
                                                         s0, dtype),
                   None, nbytes(yr, sr, dt, a, c, y2, f) +
                   (0 if s0 is None else nbytes(s0)), f_scan,
                   scale=max(1.0, ref.abs().max().item()),
                   ops_dtype="float32", plain_reps=5)
        del xbc, x, b, c, dt, y, st, yr, sr, y2, f, y2r, fr, out, ref
        torch.cuda.empty_cache()


def k1_rows(torch, rows, cfg, dev, randn, gen, dname: str, max_len: int,
            cases=None, int8_cases=None):
    """K1 and K1-int8 against their plain versions at the hit step's and
    the dense history's shapes (``cases`` / ``int8_cases``: a subset of
    :func:`k1_cases` / :func:`k1_int8_cases`, default all)."""
    from repro_torch.kernels import decode_attention as DA
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, dname)
    if cases is None:
        cases = k1_cases(torch, cfg, dev, max_len)
    if int8_cases is None:
        int8_cases = k1_int8_cases(torch, cfg, dev, max_len)
    for label, B, S, lo, hi in cases:
        q = randn((B, H, D), dt)
        k = randn((B, S, KV, D), dt)
        v = randn((B, S, KV, D), dt)
        n = (hi - lo).clamp(min=0)
        used = int(n.sum()) * KV * D * k.element_size()
        out = DA.decode_attention_cuda(q, k, v, lo, hi)
        kernel_row(rows, K1, label, dname,
                   f"B={B} H={H} KV={KV} D={D} S={S}", out,
                   DA.decode_attention_plain(q, k, v, lo, hi),
                   lambda: DA.decode_attention_cuda(q, k, v, lo, hi),
                   lambda: DA.decode_attention_plain(q, k, v, lo, hi),
                   sdpa_k1(torch, q, k, v, lo, hi),
                   nbytes(q, lo, hi, out) + 2 * used,
                   4 * H * D * int(n.sum()),
                   plain_reps=5 if S > 4096 else 20)
        del q, k, v, out
        torch.cuda.empty_cache()
    for label, B, S, lo, hi in int8_cases:
        q = randn((B, H, D), dt)
        k = int8_codes(torch, gen, (B, S, KV, D), dev)
        v = int8_codes(torch, gen, (B, S, KV, D), dev)
        ks = randn((B, S, KV, 1), torch.float32).abs() * 0.02 + 1e-3
        vs = randn((B, S, KV, 1), torch.float32).abs() * 0.02 + 1e-3
        n = (hi - lo).clamp(min=0)
        used = int(n.sum()) * KV * (D + 4)        # codes + one scale
        out = DA.decode_attention_int8_cuda(q, k, v, ks, vs, lo, hi)
        kernel_row(
            rows, K1_INT8, label, dname,
            f"B={B} H={H} KV={KV} D={D} S={S} int8", out,
            DA.decode_attention_plain(q, k, v, lo, hi, 0.0, ks, vs),
            lambda: DA.decode_attention_int8_cuda(q, k, v, ks, vs, lo, hi),
            lambda: DA.decode_attention_plain(q, k, v, lo, hi, 0.0, ks, vs),
            sdpa_k1(torch, q, k, v, lo, hi, ks, vs),
            nbytes(q, lo, hi, out) + 2 * used, 4 * H * D * int(n.sum()))


def k3_rows(torch, rows, cfg, dev, randn, gen, dname: str, max_len: int,
            cases=None, quants=(False, True)):
    """K3 and K3-int8 (pages of 64) against their plain versions
    (``cases``: default :func:`k3_cases`)."""
    from repro_torch.kernels import paged_decode_attention as PD
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, dname)
    page = 64
    for quant in quants:
        for label, vlist, window, cap in cases or k3_cases(max_len):
            B, pps = len(vlist), -(-cap // page)
            pk, pv, ks, vs, pt, vl = paged_pool(
                torch, randn, gen, B, KV, D, page, pps, vlist,
                None if quant else dt, dev)
            q = randn((B, H, D), dt)
            lo, hi = PD.attended_range(vl, window, pps * page)
            n = int((hi - lo).sum())
            per_slot = KV * (D + 4) if quant else KV * D * pk.element_size()
            pages_read = sum(-(-int(h) // page) - int(lv) // page
                             for lv, h in zip(lo, hi) if h > lv)
            args = (q, pk, pv, pt, vl, 0.0, window, ks, vs)
            out = PD.paged_decode_attention_cuda(*args)
            kernel_row(
                rows, K3_INT8 if quant else K3, label, dname,
                f"B={B} H={H} KV={KV} D={D} page={page} pps={pps}"
                f"{' int8' if quant else ''} window={window}", out,
                PD.paged_decode_attention_plain(*args),
                lambda: PD.paged_decode_attention_cuda(*args),
                lambda: PD.paged_decode_attention_plain(*args),
                sdpa_k3(torch, q, pk, pv, pt, lo, hi, ks, vs),
                nbytes(q, vl, out) + 4 * pages_read + 2 * n * per_slot,
                4 * H * D * n)
            del pk, pv, ks, vs, args, out
            torch.cuda.empty_cache()


def k2_rows(torch, rows, cfg, dev, randn, dname: str, max_len: int,
            cases=None):
    """K2 against its plain version at the resync / admission shapes
    (``cases``: (label, q_pos, k_pos, causal[, window]), default
    :func:`k2_cases`)."""
    from repro_torch.kernels import flash_attention as FA
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, dname)
    for label, qp, kp, causal, *win in cases or k2_cases(torch, cfg, dev,
                                                         max_len):
        window = win[0] if win else 0
        B, Lq, Lk = qp.shape[0], qp.shape[1], kp.shape[1]
        if kp.shape[0] != B:
            kp = kp.expand(B, Lk).contiguous()
        q = randn((B, Lq, H, D), dt)
        k = randn((B, Lk, KV, D), dt)
        v = randn((B, Lk, KV, D), dt)
        mask = FA.position_mask(qp, kp, causal, window)
        square = causal and not window and qp is kp
        pairs = int(mask.sum())
        # K/V bytes only of the keys some query attends (dead keys and
        # keys past every query's position need not be read)
        keys = int(mask.any(dim=1).sum())
        used = keys * KV * D * k.element_size()
        args = (q, k, v, qp, kp, causal, window)
        out = FA.flash_attention_cuda(*args)
        kernel_row(rows, K2, label, dname,
                   f"B={B} Lq={Lq} Lk={Lk} H={H} KV={KV} D={D}"
                   f"{f' window={window}' if window else ''}", out,
                   FA.flash_attention_plain(*args),
                   lambda: FA.flash_attention_cuda(*args),
                   lambda: FA.flash_attention_plain(*args),
                   sdpa_k2(torch, q, k, v, mask, square),
                   nbytes(q, qp, kp, out) + 2 * used, 4 * H * D * pairs,
                   plain_reps=5 if Lk > 4096 else 20)
        del q, k, v, mask, out
        torch.cuda.empty_cache()


def k2_bwd_cases(torch, cfg, dev):
    """(label, q_pos, k_pos, causal, window, softcap, (H, KV, D)) at the
    shapes a tconst-41m train step at batch 8 x 1024 gives K2's backward,
    at window j = 2 of 4 (the history half live): the compress (tail
    queries over the history, keys from 512 on dead), the context
    self-attention, the restore (every history row over the tail), the
    generation window's self and cross attention and TLinFormer's history
    cross; window 0's compress (every query fully masked, every key
    dead); the base transformer's causal 1024; one case at G 3, D 64
    (smollm-360m's heads) with a softcap and a window; and
    deepseek-moe-16b's heads (16 over 16 KV heads, D 128) on a causal 1024
    at B 2."""
    from repro_torch.kernels.flash_attention import INVALID_POS
    B, N = 8, 1024
    Wh, Wg = cfg.tconst.w_oh, cfg.tconst.w_og

    def ar(n, start=0, rows=B):
        return (start + torch.arange(n, dtype=torch.int32, device=dev)
                )[None].expand(rows, n).contiguous()

    def keys(p, valid):
        return torch.where(valid, p, torch.full_like(p, INVALID_POS))

    j = 2
    pos = ar(N)
    hist_kp = keys(pos, pos < j * Wg)
    tail, gen = ar(Wh, j * Wg - Wh), ar(Wg, j * Wg)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    p600, p1024 = ar(600, rows=4), ar(N, rows=2)
    return [
        ("compress", tail, hist_kp, True, 0, 0.0, heads),
        ("compress_masked", ar(Wh, -Wh), keys(pos, pos < 0), True, 0, 0.0,
         heads),
        ("ctx_self", tail, tail, True, 0, 0.0, heads),
        ("restore", pos, tail, True, 0, 0.0, heads),
        ("gen_self", gen, gen, True, 0, 0.0, heads),
        ("gen_cross", gen, tail, True, 0, 0.0, heads),
        ("tlin_hist", gen, hist_kp, True, 0, 0.0, heads),
        ("base_causal", pos, pos, True, 0, 0.0, heads),
        ("g3_d64_cap_window", p600, p600, True, 256, 30.0, (15, 5, 64)),
        ("d128_causal", p1024, p1024, True, 0, 0.0, (16, 16, 128)),
    ]


def sdpa_bwd(torch, q, k, v, do, mask, square_causal, softcap):
    """``torch.autograd.grad`` through SDPA with the same mask (a square
    causal prompt: ``is_causal``), K/V repeated over the group, the
    forward run once outside the timed call; None under a softcap (SDPA
    has none)."""
    import torch.nn.functional as F
    if softcap > 0.0:
        return None
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.transpose(1, 2).repeat_interleave(G, dim=1).detach() \
        .requires_grad_()
    vt = v.transpose(1, 2).repeat_interleave(G, dim=1).detach() \
        .requires_grad_()
    if square_causal:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt,
                                             attn_mask=mask[:, None])
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def k2_bwd_rows(torch, rows, cfg, dev, randn, dname: str):
    """K2's forward ``lse`` and its backward kernel against their plain
    versions at :func:`k2_bwd_cases`' shapes: dq, dk and dv each within
    TOL of ``dname`` times max(1, max |plain|) (sums over up to 1024
    queries or keys, in another order); the rows' lse within TOL (fully
    masked rows: NEG_INF + log(1e-30) on both sides).  Times: the
    backward call (three launches), its plain version and SDPA's
    backward; the bound counts the four products and the recomputed
    scores (10 D operations a head and attended pair) at the peak rate of
    ``dname`` and each input read once (K/V only of attended keys)."""
    from repro_torch.kernels import flash_attention as FA
    dt = getattr(torch, dname)
    tol = TOL[dname]
    for label, qp, kp, causal, window, cap, (H, KV, D) in k2_bwd_cases(
            torch, cfg, dev):
        B, Lq, Lk = qp.shape[0], qp.shape[1], kp.shape[1]
        q, do = randn((B, Lq, H, D), dt), randn((B, Lq, H, D), dt)
        k, v = randn((B, Lk, KV, D), dt), randn((B, Lk, KV, D), dt)
        flags = (causal, window, cap)
        o, lse = FA.flash_attention_cuda(q, k, v, qp, kp, *flags,
                                         return_lse=True)
        _, lse_p = FA.flash_attention_plain(q, k, v, qp, kp, *flags,
                                            return_lse=True)
        got = FA.flash_attention_bwd_cuda(q, k, v, qp, kp, o, lse, do,
                                          *flags)
        want = FA.flash_attention_bwd_plain(q, k, v, qp, kp, o, lse, do,
                                            *flags)
        torch.cuda.synchronize()
        what = f"{K2_BWD} {label}/{dname}"
        live = lse_p > -1e30
        check(bool((lse[~live] < -1e30).all()), f"{what}: a fully masked "
              f"row's lse is not NEG_INF")
        lse_err = (lse - lse_p)[live].abs().max().item() if live.any() \
            else 0.0
        check(lse_err <= tol, f"{what}: lse differs by {lse_err} > {tol}")
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            check(g.dtype == dt and bool(torch.isfinite(g.float()).all()),
                  f"{what}: {name} is {g.dtype} or not finite")
            scale = max(1.0, w.float().abs().max().item())
            errs[name] = (g.float() - w.float()).abs().max().item()
            check(errs[name] <= tol * scale, f"{what}: max |kernel - plain| "
                  f"of {name} = {errs[name]} > {tol} x {scale}")
        mask = FA.position_mask(qp, kp, causal, window)
        pairs = int(mask.sum())
        used = int(mask.any(dim=1).sum()) * KV * D * k.element_size()
        n_bytes = nbytes(q, o, do, lse, qp, kp, *got) + 2 * used
        flops = 10 * H * D * pairs
        b, by = bound_ms(n_bytes, flops, dname)
        args = (q, k, v, qp, kp, o, lse, do, *flags)
        lib = sdpa_bwd(torch, q, k, v, do, mask,
                       causal and not window and qp is kp, cap)
        rows.append({
            "kernel": K2_BWD, "case": label, "dtype": dname,
            "shape": f"B={B} Lq={Lq} Lk={Lk} H={H} KV={KV} D={D}"
                     f"{f' window={window}' if window else ''}"
                     f"{f' softcap={cap}' if cap else ''}",
            "max_abs_err": max(errs.values()), "errs": errs,
            "lse_err": lse_err, "tol": tol, "pairs": pairs,
            "ms": time_ms(lambda: FA.flash_attention_bwd_cuda(*args),
                          reps=5, rounds=3),
            "plain_ms": time_ms(lambda: FA.flash_attention_bwd_plain(*args),
                                reps=2, rounds=3),
            "library_ms": None if lib is None else time_ms(lib, reps=5,
                                                           rounds=3),
            "bound_ms": b, "bound_by": by,
            "bytes_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
            "ops_ms": 1e3 * flops / PEAK_FLOPS[dname]})
        del q, do, k, v, o, lse, lse_p, got, want, mask, args, lib
        torch.cuda.empty_cache()


def sass_check(_build) -> dict:
    """Tensor-core instructions in the SASS of the built K2 libraries:
    every bf16 entry of flash_attention (``flash_bf16_kernel<DP>``) and of
    flash_attention_bwd (``bwd_dkdv_bf16_kernel<DP>``,
    ``bwd_dq_bf16_kernel<DP>``) must hold HMMA or HGMMA instructions; the
    backward's f32 entries (exact f32 on the CUDA cores by design) are
    reported beside them.  Returns {"bf16": {entry: count}, "f32":
    {entry: count}}, counts of HMMA/HGMMA instructions."""
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    bf16, f32 = {}, {}
    for lib, pats in (
            ("flash_attention", ((r"(flash_bf16_kernel)ILi(\d+)E", bf16),)),
            ("flash_attention_bwd",
             ((r"(bwd_(?:dkdv|dq)_bf16_kernel)ILi(\d+)E", bf16),
              (r"(bwd_(?:dkdv|dq)_kernel)IfLi(\d+)E", f32)))):
        res = subprocess.run([str(tool), "-sass", str(_build.target(lib))],
                             capture_output=True, text=True, timeout=120)
        check(res.returncode == 0, f"cuobjdump failed on {lib}: "
              f"{res.stderr.strip()}")
        counts, fn = {}, None
        for line in res.stdout.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                counts[fn] = 0
            elif fn is not None and ("HMMA" in line or "HGMMA" in line):
                counts[fn] += 1
        for f, n in counts.items():
            for pat, into in pats:
                m = re.search(pat, f)
                if m:
                    into[f"{m.group(1)}<{m.group(2)}>"] = n
    for name in ("flash_bf16_kernel", "bwd_dkdv_bf16_kernel",
                 "bwd_dq_bf16_kernel"):
        check(any(k.startswith(name + "<") for k in bf16),
              f"no {name} entry in the K2 libraries' SASS")
    check(all(n > 0 for n in bf16.values()), f"a bf16 K2 entry has no "
          f"HMMA/HGMMA instruction: {bf16}")
    return {"bf16": bf16, "f32": f32}


def launches_per_call(torch, fn) -> int:
    """Device kernels (and memsets / copies) one warm call of ``fn`` puts
    on the card, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def launch_counts(torch, cfg, dev, max_len: int) -> dict:
    """Launches per call of K1, K1-int8, K2, K3 (float and int8 pools) and
    K4's two launches at the served shapes (the hit step's gen-window
    self-attention, the compress pass, the paged history of 3 rows, a
    605-token bf16 mamba2 admission with x, b, c sliced as the mixer
    slices them), and of K2, K1 and K3 at deepseek-moe-16b's (head_dim
    128: the 1024-token prefill, a 2-row step, its paged history)."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    bf = torch.bfloat16
    _, B, S, lo, hi = k1_cases(torch, cfg, dev, max_len)[0]
    qd = randn((B, H, D), bf)
    kd, vd = randn((B, S, KV, D), bf), randn((B, S, KV, D), bf)
    kq = int8_codes(torch, gen, (B, S, KV, D), dev)
    vq = int8_codes(torch, gen, (B, S, KV, D), dev)
    sc = randn((B, S, KV, 1), torch.float32).abs() * 0.02 + 1e-3
    out = {K1: launches_per_call(
        torch, lambda: DA.decode_attention_cuda(qd, kd, vd, lo, hi)),
        K1_INT8: launches_per_call(
        torch, lambda: DA.decode_attention_int8_cuda(qd, kq, vq, sc, sc, lo,
                                                     hi))}
    _, qp, kp, _ = k2_cases(torch, cfg, dev, max_len)[0]
    q = randn((2, qp.shape[1], H, D), bf)
    k, v = randn((2, kp.shape[1], KV, D), bf), randn((2, kp.shape[1], KV, D),
                                                     bf)
    out[K2] = launches_per_call(
        torch, lambda: FA.flash_attention_cuda(q, k, v, qp, kp, True))
    o, lse = FA.flash_attention_cuda(q, k, v, qp, kp, True, return_lse=True)
    out[K2_BWD] = launches_per_call(
        torch, lambda: FA.flash_attention_bwd_cuda(q, k, v, qp, kp, o, lse,
                                                   o, True))
    # deepseek's shapes (H 16 over 16 KV heads, head_dim 128): the
    # 1024-token causal prefill, the step over 2 rows, the paged history
    from repro_torch.config import get_config
    ds = get_config(DEEPSEEK)
    Hd, KVd, Dd = ds.n_heads, ds.n_kv_heads, ds.resolved_head_dim
    pos = torch.arange(1024, dtype=torch.int32, device=dev)[None]
    qp2 = randn((1, 1024, Hd, Dd), bf)
    kp2, vp2 = randn((1, 1024, KVd, Dd), bf), randn((1, 1024, KVd, Dd), bf)
    out[K2 + "@deepseek"] = launches_per_call(
        torch, lambda: FA.flash_attention_cuda(qp2, kp2, vp2, pos, pos,
                                               True))
    qd2 = randn((2, Hd, Dd), bf)
    kd2, vd2 = randn((2, max_len, KVd, Dd), bf), \
        randn((2, max_len, KVd, Dd), bf)
    hi2 = torch.tensor([600, min(935, max_len)], dtype=torch.int32,
                       device=dev)
    lo2 = torch.zeros_like(hi2)
    out[K1 + "@deepseek"] = launches_per_call(
        torch, lambda: DA.decode_attention_cuda(qd2, kd2, vd2, lo2, hi2))
    pk, pv, ks, vs, pt, vl = paged_pool(torch, randn, gen, 2, KVd, Dd, 64,
                                        -(-max_len // 64),
                                        [600, min(935, max_len)], bf, dev)
    out[K3 + "@deepseek"] = launches_per_call(
        torch, lambda: PD.paged_decode_attention_cuda(qd2, pk, pv, pt, vl,
                                                      0.0, 0, ks, vs))
    for name, pool in ((K3, bf), (K3_INT8, None)):
        pk, pv, ks, vs, pt, vl = paged_pool(torch, randn, gen, 3, KV, D, 64,
                                            -(-max_len // 64),
                                            [0, 613, min(960, max_len)], pool,
                                            dev)
        qd = randn((3, H, D), bf)
        out[name] = launches_per_call(
            torch, lambda: PD.paged_decode_attention_cuda(
                qd, pk, pv, pt, vl, 0.0, 0, ks, vs))
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.layers.ssm import ssm_dims
    scfg = get_config(SSM)
    dims = ssm_dims(scfg)
    H, P, N, Q = dims.n_heads, dims.head_dim, dims.n_state, scfg.ssm_chunk
    xbc = randn((1, 605, H * P + 2 * N), bf)
    x = xbc[..., :H * P].reshape(1, 605, H, P)
    b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(randn((1, 605, H), torch.float32))
    a = -torch.arange(1, H + 1, device=dev, dtype=torch.float32)
    yi, st = SS.ssd_intra_chunk_cuda(x, dt, a, b, c, Q)
    out[K4_INTRA] = launches_per_call(
        torch, lambda: SS.ssd_intra_chunk_cuda(x, dt, a, b, c, Q))
    out[K4_SCAN] = launches_per_call(
        torch, lambda: SS.ssd_chunk_scan_cuda(yi, st, dt, a, c, Q))
    return out


def lm_rows(torch, rows, dev, randn, gen, dname: str, max_len: int):
    """The kernels at the shapes the attention LMs' runs give them:
    smollm-360m (G 3, head_dim 64) K1 over its KV cache (hi 600 and 935,
    and a row with lo > 0), K3 over its pages (window 0 and 256) and K2's
    causal prefill of 600 and 1024 tokens (and 1024 under a 256 window);
    the base transformer (G 1, head_dim 36) K1-int8 and K3-int8 over its
    cache and K2's 1024-token prefill; deepseek-moe-16b (G 1, head_dim
    128) K1 and K3 over its cache and K2's prefill of 600 and 1024, and
    in tconst mode K2's compress and restore and K1 over the window and
    the context slots; minicpm-2b (G 1, head_dim 64) K1 over its cache
    and K2's prefill of 1024."""
    from repro_torch.config import get_config
    t = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa

    def square(L):
        return torch.arange(L, dtype=torch.int32, device=dev)[None]

    def prefills(prefix, lens, window=0):
        """Square causal prompts: one position tensor as q_pos and k_pos
        (``k2_rows`` then times SDPA with ``is_causal``)."""
        out = []
        for L in lens:
            pos = square(L)
            out.append((f"{prefix}_prefill_{L}", pos, pos, True))
        if window:
            pos = square(lens[-1])
            out.append((f"{prefix}_prefill_{lens[-1]}_w{window}", pos, pos,
                        True, window))
        return out

    hist = [600, min(935, max_len), 0]
    smollm = get_config(SMOLLM)
    k1_rows(torch, rows, smollm, dev, randn, gen, dname, max_len,
            cases=[("smollm_step", 2, max_len, t([0, 0]), t(hist[:2])),
                   ("smollm_lo", 2, max_len, t([344, 679]), t(hist[:2]))],
            int8_cases=[])
    k3_rows(torch, rows, smollm, dev, randn, gen, dname, max_len,
            cases=[("smollm_hist", hist, 0, max_len),
                   ("smollm_window", hist, 256, max_len)], quants=(False,))
    k2_rows(torch, rows, smollm, dev, randn, dname, max_len,
            cases=prefills("smollm", [600, 1024], 256))
    base = get_config("tconst-41m", attention_mode="full")
    k1_rows(torch, rows, base, dev, randn, gen, dname, max_len, cases=[],
            int8_cases=[("base_int8_step", 2, max_len, t([0, 0]),
                         t(hist[:2]))])
    k3_rows(torch, rows, base, dev, randn, gen, dname, max_len,
            cases=[("base_hist", hist, 0, max_len)], quants=(True,))
    k2_rows(torch, rows, base, dev, randn, dname, max_len,
            cases=prefills("base", [1024]))
    # deepseek-moe-16b (H 16 over 16 KV heads, head_dim 128): K2's first
    # runs at D 128, K1 / K3 at D 128 with G 1
    deepseek = get_config(DEEPSEEK)
    k1_rows(torch, rows, deepseek, dev, randn, gen, dname, max_len,
            cases=[("deepseek_step", 2, max_len, t([0, 0]), t(hist[:2]))],
            int8_cases=[])
    k3_rows(torch, rows, deepseek, dev, randn, gen, dname, max_len,
            cases=[("deepseek_hist", hist, 0, max_len)], quants=(False,))
    k2_rows(torch, rows, deepseek, dev, randn, dname, max_len,
            cases=prefills("deepseek", [600, 1024]))
    # deepseek in tconst mode: the resync's compress (256 tail queries
    # over the 999-slot history) and restore (999 queries over the 256
    # slots), K1 over the 256-slot generation window and context slots
    tc = {c[0]: c for c in k2_cases(torch, deepseek, dev, max_len)}
    k2_rows(torch, rows, deepseek, dev, randn, dname, max_len,
            cases=[(f"deepseek_{n}",) + tc[n][1:]
                   for n in ("compress", "restore")])
    k1_rows(torch, rows, deepseek, dev, randn, gen, dname, max_len,
            cases=[(f"deepseek_{c[0]}",) + c[1:]
                   for c in k1_cases(torch, deepseek, dev, max_len)
                   if c[0] in ("self_full", "cross_partial")],
            int8_cases=[])
    # minicpm-2b (36 heads over 36 KV heads, head_dim 64): K1 over its KV
    # cache and K2's 1024-token causal prefill
    minicpm = get_config(MINICPM)
    k1_rows(torch, rows, minicpm, dev, randn, gen, dname, max_len,
            cases=[("minicpm_step", 2, max_len, t([0, 0]), t(hist[:2]))],
            int8_cases=[])
    k2_rows(torch, rows, minicpm, dev, randn, dname, max_len,
            cases=prefills("minicpm", [1024]))


def kernel_phase(torch, cfg, dev, max_len: int):
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    for dname in ("bfloat16", "float32"):
        k1_rows(torch, rows, cfg, dev, randn, gen, dname, max_len)
        k3_rows(torch, rows, cfg, dev, randn, gen, dname, max_len)
        k2_rows(torch, rows, cfg, dev, randn, dname, max_len)
        lm_rows(torch, rows, dev, randn, gen, dname, max_len)
        k2_bwd_rows(torch, rows, cfg, dev, randn, dname)
    ssd_phase(torch, rows, dev, gen)
    for r in rows:
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f}"
        print(f"[kernel] {r['kernel']:27s} {r['case']:15s} {r['dtype']:8s} "
              f"{r['shape']:50s} err={r['max_abs_err']:.2e} "
              f"ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"library={lib} bound={r['bound_ms']:.5f} ({r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the port's main paths
# ---------------------------------------------------------------------------


def session_argv(mode: str, layout: str, dtype: str):
    """The launcher's argv of one sessions run (f32 runs of the layouts
    added after the first slice at the shorter F32_ARGS, of the dense LMs
    and deepseek at F32_LM_ARGS; deepseek's bf16 runs at
    DEEPSEEK_BF16_ARGS; deepseek in tconst mode at F32_ARGS in both
    dtypes)."""
    argv = SESSIONS_ARGS + ["--arch", MODELS[mode][0], "--dtype", dtype,
                            "--layout", layout]
    if mode == "deepseek-tconst":
        argv += F32_ARGS
    elif dtype == "float32" and mode in ("smollm", "full", "deepseek"):
        argv += F32_LM_ARGS
    elif dtype == "float32" and layout != "dense":
        argv += F32_ARGS
    elif mode == "deepseek":
        argv += DEEPSEEK_BF16_ARGS
    if layout.startswith("paged"):
        argv += F32_PAGED_ARGS if dtype == "float32" else PAGED_ARGS
    return argv


def serve_phase(torch, runtime, serve, mode: str, layout: str, dtype: str,
                kernels, **overrides):
    """One sessions run of the main path: counters reset right before
    the scheduler, read right after it; then the checks.  ``overrides``
    replace config fields of the run's model (deepseek's depth)."""
    args = serve.parse_args(session_argv(mode, layout, dtype))
    cfg, api, params = serve.load(args, **MODELS[mode][1], **overrides)
    torch.cuda.synchronize()
    runtime.reset_counters()
    served = serve.serve_sessions(cfg, api, params, args)
    torch.cuda.synchronize()
    counts = runtime.read_counters()
    sched = served["sched"]
    what = f"{mode}/{layout} {dtype} sessions"
    for name, c in counts.items():
        if name in kernels:
            check(c["kernel"] > 0, f"{what}: kernel {name} was never "
                  f"launched ({counts})")
        else:
            check(c["kernel"] == 0, f"{what}: kernel {name} is not on this "
                  f"path but launched ({counts})")
        check(c["plain"] == 0, f"{what}: plain version of {name} ran on "
              f"the main path ({counts})")
    for s in served["sessions"]:
        check(len(s.tokens) == args.gen, f"{what}: session {s.sid}: "
              f"{len(s.tokens)} tokens, expected {args.gen}")
        # the SSM family and the dense LMs have no resync
        check(mode not in RESYNCING or sched.resyncs.get(s.sid, 0) >= 1,
              f"{what}: session {s.sid} crossed no resync")
    if sched._paged:
        check(sched.peak_active >= 2, f"{what}: fewer than two sessions "
              f"decoded at once")
        check(sched.page_waits >= 1, f"{what}: no admission waited for "
              f"pool pages")
        check(sorted(sched.free_pages) == list(range(
            sched.layout.pool_pages)), f"{what}: pages leaked")
    rep = {"seconds": served["seconds"], "launches": counts,
           "page_waits": sched.page_waits, "peak_active": sched.peak_active,
           "kv_bytes": sched.kv_bytes()}
    # the solo runs the streams are checked against come after the read;
    # the first slice's tconst/dense run keeps its own in bf16 too
    if dtype == "float32" or (mode, layout) == ("tconst", "dense"):
        chk = serve.check_sessions(api, params, served, args)
        rep["sessions"] = [{k: s[k] for k in ("sid", "prompt_len",
                                              "resyncs", "matches")}
                           for s in chk["sessions"]]
        if dtype == "float32":
            check(chk["rc"] == 0 and all(s["matches"]
                                         for s in chk["sessions"]),
                  f"{what}: f32 greedy streams differ from their solo runs")
    return cfg, args, params, rep


@contextlib.contextmanager
def route_log():
    """While active, record the routing of every MoE layer that runs:
    for each ``route_topk`` call, each token's expert set, sorted, as a
    (tokens, K) CPU tensor, in call order."""
    from repro_torch.layers import moe
    orig, calls = moe.route_topk, []

    def logged(logits, top_k, capacity):
        out = orig(logits, top_k, capacity)
        calls.append(out[0].transpose(-1, -2).reshape(-1, top_k)
                     .sort(dim=-1).values.cpu())
        return out

    moe.route_topk = logged
    try:
        yield calls
    finally:
        moe.route_topk = orig


def synced(dec, params, st):
    """``st`` after the resync of its rows whose window is full (TConst:
    a reduced model's W_og 8 fills within ``LOGIT_STEPS``), as the decode
    loop runs it before a step."""
    rows = dec.sync_candidates(st)
    return dec.sync_rows(params, st, rows) if rows.any() else st


def cpu_reference(torch, serve, cfg, args, params, n_prompts=None):
    """The plain path on the CPU in f32, same weights and layout (full
    pool), on the first ``n_prompts`` session prompts: per prompt, the
    logits of the first token and of ``LOGIT_STEPS`` greedy steps after
    it, each with the expert sets its MoE layers chose."""
    from repro_torch.models.api import build_decode
    spec = serve.layout_spec(args, full_pool=True)
    dec = build_decode(cfg.replace(dtype="float32"), spec, device="cpu")
    ref_params = dec.prepare_params(params)
    out = []
    for p in serve.session_prompts(cfg, args)[:n_prompts]:
        with route_log() as routes:
            logits, st = dec.prefill(ref_params, {"tokens": p[None]},
                                     serve.sessions_max_len(args))
        steps = [(logits, routes)]
        for _ in range(LOGIT_STEPS):
            with route_log() as routes:
                st = synced(dec, ref_params, st)
                logits, st = dec.raw_step(
                    ref_params, st, logits.argmax(dim=-1).to(torch.int32))
            steps.append((logits, routes))
        out.append((p, steps))
    return out


def logits_phase(torch, serve, cfg, args, params, tol, n_prompts=None,
                 device="cuda", ref=None):
    """Logits of session prompts on the card (kernels) against the plain
    path on the CPU in f32, same weights and layout (full pool): the
    first token (the admission: K2, or K4 for mamba2) and
    ``LOGIT_STEPS`` cache-hit steps after it (K1 / K1-int8 / K3; mamba2's
    plain recurrent step), both fed the reference's greedy tokens.
    ``tol``: the largest error allowed; ``ref``: a
    :func:`cpu_reference` of these weights to reuse.  Each record counts
    the routed tokens (token x MoE layer) and those whose expert set
    differs from the reference's."""
    from repro_torch.models.api import build_decode
    if ref is None:
        ref = cpu_reference(torch, serve, cfg, args, params, n_prompts)
    max_len = serve.sessions_max_len(args)
    card_dec = build_decode(cfg, serve.layout_spec(args, full_pool=True),
                            device=device)
    card_params = card_dec.prepare_params(params)
    errs = []
    for p, steps in ref:
        for step, (want, want_routes) in enumerate(steps):
            what = "first-token" if step == 0 else f"step-{step}"
            with route_log() as routes:
                if step == 0:
                    got, st = card_dec.prefill(card_params,
                                               {"tokens": p[None]}, max_len)
                else:
                    tok = steps[step - 1][0].argmax(dim=-1).to(torch.int32)
                    st = synced(card_dec, card_params, st)
                    got, st = card_dec.raw_step(card_params, st,
                                                tok.to(device))
            check(bool(torch.isfinite(got).all()), f"non-finite {what} "
                  f"logits")
            err = (got.float().cpu() - want).abs().max().item()
            check(err <= tol, f"{cfg.name} {cfg.attention_mode}/"
                  f"{args.layout} {cfg.dtype} {what} logits differ from "
                  f"the CPU plain path by {err} > {tol}")
            errs.append({"prompt_len": len(p), "step": step, "err": err,
                         "routed": sum(r.shape[0] for r in want_routes),
                         "route_flips": sum(
                             int((a != b).any(dim=-1).sum())
                             for a, b in zip(routes, want_routes))})
    return errs


def summarize(errs) -> dict:
    """The largest first-token and step errors of ``logits_phase`` records
    and their routing counts."""
    return {"first": max(e["err"] for e in errs if e["step"] == 0),
            "steps": max(e["err"] for e in errs if e["step"] > 0),
            "route_flips": sum(e["route_flips"] for e in errs),
            "routed": sum(e["routed"] for e in errs)}


def moe_logits_phase(torch, serve, cfg, args, params) -> dict:
    """deepseek at ``DEEPSEEK_CHECK_DEPTH`` on f32 weights: the card's f32
    path and its bf16 path (these weights cast, as the bf16 init draws
    them) against one CPU f32 reference, within ``LOGIT_TOL_MOE``."""
    ref = cpu_reference(torch, serve, cfg, args, params, n_prompts=2)
    return {dtype: summarize(logits_phase(
        torch, serve, cfg.replace(dtype=dtype), args, params,
        LOGIT_TOL_MOE[dtype], ref=ref)) for dtype in ("float32", "bfloat16")}


def finite_logits(torch, serve, cfg, args, params, steps: int = 2) -> bool:
    """The first session prompt's admission and ``steps`` greedy steps on
    the card, whose logits must be finite (the full-depth runs: a CPU
    reference of 16.4 B parameters would not fit the time)."""
    from repro_torch.models.api import build_decode
    dec = build_decode(cfg, serve.layout_spec(args, full_pool=True),
                       device="cuda")
    p = dec.prepare_params(params)
    prompt = serve.session_prompts(cfg, args)[0]
    logits, st = dec.prefill(p, {"tokens": prompt[None]},
                             serve.sessions_max_len(args))
    for step in range(steps + 1):
        check(bool(torch.isfinite(logits).all()), f"{cfg.name} "
              f"{args.layout} {cfg.dtype}: non-finite logits at step {step}")
        if step < steps:
            logits, st = dec.raw_step(p, st,
                                      logits.argmax(dim=-1).to(torch.int32))
    return True


def kv_bytes_per_slot(torch, serve, max_len: int) -> dict:
    """``DecodeState.kv_bytes`` of one bf16 slot on the dense layout at
    ``max_len`` for tconst-41m, its base transformer, smollm-360m and
    deepseek-moe-16b (meta tensors: nothing is allocated)."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.models.api import build_decode
    out = {}
    for mode in ("tconst", "full", "smollm", "deepseek", "deepseek-tconst"):
        arch, over = MODELS[mode]
        dec = build_decode(get_config(arch, **over), device="cpu")
        meta = dataclasses.replace(dec, device=torch.device("meta"))
        out[f"{arch} {dec.cfg.attention_mode}"] = \
            meta.init_state(1, max_len).kv_bytes()
    return out


def layout_kernels(cfg, layout: str):
    """The kernels a served model launches on ``layout``: an LM's
    (``LAYOUT_KERNELS``), or the TConst core's -- K1 / K1-int8 over the
    window and the context slots, K2, and in tlin mode K3 / K3-int8 over
    the paged history."""
    if cfg.attention_mode not in TCONST_MODES:
        return LAYOUT_KERNELS[layout]
    quant = "int8" in layout
    hist = (K3_INT8 if quant else K3,) if cfg.attention_mode == "tlin" \
        and layout.startswith("paged") else ()
    return (K1_INT8 if quant else K1, K2) + hist


def window_phase(torch, runtime, serve) -> dict:
    """Sliding windows through a served model on every layout (f32,
    reduced widths), and reduced models the full-width runs do not reach
    on every layout (MoE FFNs in the TConst core, minicpm-2b).  Each card
    run must launch exactly its layout's kernels and no plain version.  The card's logits along the CPU plain
    path's greedy tokens (``logits_phase``: the admission and
    ``LOGIT_STEPS`` steps, every one past the window) must be within the
    f32 ``LOGIT_TOL``; the greedy session streams must equal the CPU's on
    the float layouts.  On the int8 layouts a K/V whose f32 value sits at
    a .5 boundary of x / scale may be stored one code apart on the two
    devices (their GEMMs sum in other orders), which moves the logits by
    ~3e-4 while the window holds it and can flip a near-tied greedy token
    of these random weights: there the streams are recorded, not
    required equal, and a TConst model's logits are held from the card's
    stored cache (:func:`adopted_logits`)."""
    from repro_torch.models.api import build_model
    from repro_torch.models.lm import layer_windows
    out = {}
    for name, (arch, over) in WINDOW_MODELS.items():
        for layout in LAYOUT_KERNELS:
            argv = WINDOW_ARGS + ["--arch", arch, "--layout", layout]
            streams, counts = {}, None
            # one set of weights: the MoE family draws its own on the card
            # (a CUDA generator), so the CPU run takes the card's
            cfg, _, params = serve.load(
                serve.parse_args(argv + ["--device", "cuda"]), **over)
            kernels = layout_kernels(cfg, layout)
            for device in ("cuda", "cpu"):
                args = serve.parse_args(argv + ["--device", device])
                runtime.reset_counters()
                served = serve.serve_sessions(
                    cfg, build_model(cfg, device=device), params, args)
                if device == "cuda":
                    torch.cuda.synchronize()
                    counts = runtime.read_counters()
                streams[device] = [list(s.tokens) for s in
                                   served["sessions"]]
            what = f"windows {name}/{layout}"
            check(set(counts) >= set(kernels), f"{what}: {counts}")
            for n, c in counts.items():
                check((c["kernel"] > 0) == (n in kernels) and
                      c["plain"] == 0, f"{what}: launches {counts}")
            adopt = "int8" in layout and cfg.attention_mode in TCONST_MODES
            errs = (adopted_logits if adopt else logits_phase)(
                torch, serve, cfg, args, params, LOGIT_TOL["float32"])
            same = streams["cuda"] == streams["cpu"]
            check(same or "int8" in layout, f"{what}: greedy streams "
                  f"differ from the CPU plain path's")
            out[f"{name}/{layout}"] = {
                "windows": sorted(set(layer_windows(cfg))),
                "launches": {n: c["kernel"] for n, c in counts.items()
                             if c["kernel"]},
                "streams_equal": same,
                "logit_max_err": max(e["err"] for e in errs),
                "codes_adopted": sum(e.get("codes_adopted", 0)
                                     for e in errs)}
    return out


def adopted_logits(torch, serve, cfg, args, params, tol):
    """``logits_phase`` for a TConst model on an int8 layout, with the
    card and the CPU plain path in lockstep, the CPU stepping on from the
    card's stored codes and scales after each call.  A reduced model has
    W_oh = 8 context slots, which every later token reads at every layer,
    and a resync re-quantizes all of them: one code stored one apart (a
    K/V at a .5 boundary of x / scale, the two devices' GEMMs summing in
    other orders) moves the next tokens' K/V across more boundaries, and
    the logits apart by more than the f32 tolerance within a few steps,
    with no routing change (reduced deepseek in tconst mode, int8: 2.1e-3
    against 2e-3 when the CPU kept its own codes).  Each step is held to
    ``tol`` from the same stored cache; each record counts the codes the
    CPU adopted."""
    from repro_torch.models.api import build_decode
    spec = serve.layout_spec(args, full_pool=True)
    max_len = serve.sessions_max_len(args)
    cpu = build_decode(cfg.replace(dtype="float32"), spec, device="cpu")
    card = build_decode(cfg, spec, device="cuda")
    ref_params, card_params = cpu.prepare_params(params), \
        card.prepare_params(params)
    errs = []
    for p in serve.session_prompts(cfg, args):
        for step in range(LOGIT_STEPS + 1):
            with route_log() as want_routes:
                if step == 0:
                    want, ref = cpu.prefill(ref_params, {"tokens": p[None]},
                                            max_len)
                else:
                    tok = want.argmax(dim=-1).to(torch.int32)
                    ref = synced(cpu, ref_params, ref)
                    want, ref = cpu.raw_step(ref_params, ref, tok)
            with route_log() as routes:
                if step == 0:
                    got, st = card.prefill(card_params, {"tokens": p[None]},
                                           max_len)
                else:
                    st = synced(card, card_params, st)
                    got, st = card.raw_step(card_params, st,
                                            tok.to(card.device))
            what = "first-token" if step == 0 else f"step-{step}"
            check(bool(torch.isfinite(got).all()), f"non-finite {what} "
                  f"logits")
            err = (got.float().cpu() - want).abs().max().item()
            check(err <= tol, f"{cfg.name} {cfg.attention_mode}/"
                  f"{args.layout} {cfg.dtype} {what} logits differ from "
                  f"the CPU plain path (from the card's stored cache) by "
                  f"{err} > {tol}")
            adopted = 0
            for f, v in st.kv.items():
                v = v.cpu()
                if f.endswith("__q"):
                    adopted += int((v != ref.kv[f]).sum())
                ref.kv[f].copy_(v)
            check(all(torch.equal(v.cpu(), ref.bookkeeping[f])
                      for f, v in st.bookkeeping.items()),
                  f"{cfg.name} {args.layout}: the card's bookkeeping "
                  f"differs from the CPU's")
            errs.append({"prompt_len": len(p), "step": step, "err": err,
                         "routed": sum(r.shape[0] for r in want_routes),
                         "route_flips": sum(
                             int((a != b).any(dim=-1).sum())
                             for a, b in zip(routes, want_routes)),
                         "codes_adopted": adopted})
    return errs


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------


def step_profile(torch, runtime, step_fn, params, opt, batch) -> dict:
    """One warm train step under torch.profiler: its device launches and
    device ms (summed kernel time), K2's forward and backward device ms
    (their kernels' names), and the K2 forward / backward wrapper calls
    of the step (launch counters)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    runtime.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn(params, opt, batch)
        float(out[2]["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = runtime.read_counters()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]

    def us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    def ms(marker):
        return sum(us(e) for e in dev if marker in e.key) / 1e3
    top = sorted(dev, key=us, reverse=True)[:6]
    return {"launches": sum(e.count for e in dev),
            "device_ms": sum(us(e) for e in dev) / 1e3,
            "k2_fwd_ms": ms("::flash_bf16_kernel"),
            "k2_bwd_ms": ms("::bwd_"),
            "wall_ms_profiled": 1e3 * wall,
            "k2_fwd_calls": counts[K2]["kernel"],
            "k2_bwd_calls": counts[K2_BWD]["kernel"],
            "top": [(e.key[:60], e.count, us(e) / 1e3) for e in top]}


def train_phase(torch, runtime) -> dict:
    """tconst-41m at full width, bf16, batch 8 x 1024, through the train
    launcher (``launch.train.load`` / ``train``) in modes tconst, tlin and
    full on one seeded init, in turns A B C C B A over the same
    synthetic batches.  Each run: launch counters reset before it and
    read after it (K2's forward and backward kernels launched, no plain
    version, no other kernel); a finite loss that falls; warm step ms
    (each step ends at its loss read), tok/s and peak device memory.  The
    first run of each mode also profiles one more step."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.launch import train as T
    from repro_torch.training.optim import AdamWConfig
    from repro_torch.training.schedules import warmup_cosine
    from repro_torch.training.train_step import make_train_step
    base = T.build_parser().parse_args(TRAIN_ARGS)
    t0 = time.time()
    data = list(batches(DataConfig(vocab_size=50257, seq_len=base.seq,
                                   batch_size=base.batch, seed=base.seed),
                        steps=base.steps))
    out = {"data_s": time.time() - t0, "runs": {}}
    for mode in TRAIN_TURNS + TRAIN_TURNS[::-1]:
        args = T.build_parser().parse_args(TRAIN_ARGS + ["--mode", mode])
        cfg, api, params = T.load(args)
        check(cfg.dtype == "bfloat16" and cfg.d_model == 432,
              f"train {mode}: not the full-width bf16 config")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runtime.reset_counters()
        res = T.train(cfg, api, params, args, data=data, log=lambda _: None)
        torch.cuda.synchronize()
        counts = runtime.read_counters()
        what = f"train {mode}"
        for name, c in counts.items():
            check(c["plain"] == 0, f"{what}: plain version of {name} ran "
                  f"({counts})")
            check((c["kernel"] > 0) == (name in (K2, K2_BWD)),
                  f"{what}: launches {counts}")
        losses = res["losses"]
        check(all(x == x and abs(x) < 1e4 for x in losses),
              f"{what}: non-finite loss {losses}")
        check(losses[-1] < losses[0], f"{what}: the loss did not fall "
              f"{losses}")
        warm = statistics.median(res["step_s"][1:])
        rec = {"losses": losses, "grad_norms": res["grad_norms"],
               "step_ms": [1e3 * x for x in res["step_s"]],
               "warm_step_ms": 1e3 * warm,
               "tok_s": base.batch * base.seq / warm,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": {n: c["kernel"] for n, c in counts.items()
                            if c["kernel"]}}
        runs = out["runs"].setdefault(mode, [])
        if not runs:
            step_fn = make_train_step(api, AdamWConfig(lr=args.lr),
                                      warmup_cosine(0, args.steps))
            batch = {"tokens": torch.from_numpy(np.ascontiguousarray(
                data[0]["tokens"][:, :args.seq])).cuda()}
            rec["profile"] = step_profile(torch, runtime, step_fn,
                                          res["params"], res["opt"], batch)
        runs.append(rec)
        del res, params, api
        torch.cuda.empty_cache()
    return out


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over all leaves (f32, on the CPU)."""
    from repro_torch.training.optim import tree_leaves
    num = den = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        num += float((g - w).square().sum())
        den += float(w.square().sum())
    return (num / den) ** 0.5


def grad_check_phase(torch, runtime) -> dict:
    """Loss and gradients of tconst-41m at full width (tconst, tlin,
    full), B 1 x 512, on the card against the CPU plain path on the same
    f32 params: f32 within ``GRAD_TOL_F32``; bf16 within
    ``GRAD_BF16_FACTOR`` times the CPU plain path's own bf16 error, both
    against the CPU f32 reference.  Each card run launches K2's forward
    and backward kernels and no plain version."""
    import numpy as np
    from repro_torch import bridge
    from repro_torch.config import get_config
    from repro_torch.models.api import build_model
    from repro_torch.training.optim import tree_map
    from repro_torch.training.train_step import loss_and_grads
    B, L = GRAD_CHECK_SHAPE
    threads = torch.get_num_threads()
    out = {}
    for mode in TRAIN_TURNS:
        cfg = get_config("tconst-41m", attention_mode=mode,
                         dtype="float32")
        toks = torch.from_numpy(np.random.RandomState(1).randint(
            0, cfg.vocab_size, size=(B, L)))
        params = bridge.stack_params(build_model(cfg, device="cpu").init(0))
        card_params = tree_map(lambda p: p.cuda(), params)
        res = {}
        for dname in ("float32", "bfloat16"):
            c = cfg.replace(dtype=dname)
            torch.set_num_threads(min(threads, 4))
            try:
                res[f"cpu_{dname}"] = loss_and_grads(
                    build_model(c, device="cpu"), params, {"tokens": toks})
            finally:
                torch.set_num_threads(threads)
            runtime.reset_counters()
            res[f"card_{dname}"] = loss_and_grads(
                build_model(c, device="cuda"), card_params,
                {"tokens": toks.cuda()})
            torch.cuda.synchronize()
            counts = runtime.read_counters()
            check(all(counts[n]["kernel"] > 0 for n in (K2, K2_BWD)) and
                  all(x["plain"] == 0 for x in counts.values()),
                  f"grad check {mode} {dname}: launches {counts}")
        ref = res["cpu_float32"][1]
        rec = {"loss_cpu_f32": float(res["cpu_float32"][0]),
               "loss_card_f32": float(res["card_float32"][0]),
               "loss_card_bf16": float(res["card_bfloat16"][0]),
               "err_f32": _rel_l2(res["card_float32"][1], ref),
               "err_bf16": _rel_l2(res["card_bfloat16"][1], ref),
               "err_cpu_bf16": _rel_l2(res["cpu_bfloat16"][1], ref)}
        rec["tol_bf16"] = GRAD_BF16_FACTOR * rec["err_cpu_bf16"]
        check(rec["err_f32"] <= GRAD_TOL_F32, f"grad check {mode}: f32 "
              f"gradients differ from the CPU's by {rec['err_f32']} > "
              f"{GRAD_TOL_F32}")
        check(abs(rec["loss_card_f32"] - rec["loss_cpu_f32"]) <= 1e-4,
              f"grad check {mode}: f32 loss {rec}")
        check(rec["err_bf16"] <= rec["tol_bf16"], f"grad check {mode}: bf16 "
              f"gradients differ from the CPU f32 ones by {rec['err_bf16']} "
              f"> {rec['tol_bf16']}")
        out[mode] = rec
        del res, params, card_params
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is False: this script "
                         "needs an NVIDIA GPU")
    check((SRC / "repro_torch" / "csrc").is_dir(),
          f"{SRC / 'repro_torch'} not found: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 GEMMs in full f32
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    t_start = time.time()

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    # 2. build
    from repro_torch import runtime
    from repro_torch.kernels import _build
    t0 = time.time()
    built = _build.build(verbose=True)
    build_s = time.time() - t0
    check(all(_build.target(n).exists() for n in _build.SOURCES),
          f"not every source of {_build.SOURCES} was built")
    for name, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] nvcc -gencode arch=compute_90a,code=sm_90a: "
          f"{ {k: round(v, 2) for k, v in built.items()} } "
          f"(wall {build_s:.2f}s)")
    sass = sass_check(_build)
    print(f"[sass] HMMA/HGMMA instructions of K2's bf16 entries (forward "
          f"and backward): {sass['bf16']}; the backward's f32 entries: "
          f"{sass['f32']}")

    from repro_torch.config import get_config
    from repro_torch.launch import serve
    cfg41 = get_config("tconst-41m")
    dev = torch.device("cuda")
    max_len = serve.sessions_max_len(serve.parse_args(SESSIONS_ARGS))

    # 3. kernels vs plain
    t_phase = time.time()
    rows = kernel_phase(torch, cfg41, dev, max_len)
    per_call = launch_counts(torch, cfg41, dev, max_len)
    print(f"[launches] device launches per call: {per_call}")
    check(per_call[K2_BWD] == 3, f"K2's backward must take three device "
          f"launches a call (delta, dk/dv, dq): {per_call}")
    check(all(n == 1 for name, n in per_call.items() if name != K2_BWD),
          f"K1 / K2 / K3 / K4 must take one device launch a call: "
          f"{per_call}")
    phase_s = {"kernels": time.time() - t_phase}

    # 4. serve at full width: every run is a main path, counted alone
    runs = {}
    for mode, layout, kernels in SESSION_RUNS:
        for dtype in ("bfloat16", "float32"):
            t_phase = time.time()
            cfg, args, params, rep = serve_phase(
                torch, runtime, serve, mode, layout, dtype, kernels,
                **RUN_OVERRIDES.get((mode, dtype), {}))
            tol = LOGIT_TOL_MOE if mode in MOE_MODES else \
                {"mamba2": LOGIT_TOL_SSM, **LOGIT_TOL_LM}.get(
                    mode, LOGIT_TOL).get(dtype)
            if mode in MOE_MODES and dtype == "bfloat16":
                rep["finite_logits"] = finite_logits(torch, serve, cfg, args,
                                                     params)
            elif mode in MOE_MODES:
                # both dtypes' logits at the checked depth, on the bf16
                # runs' prompts (600 and 605: those of LOGIT_TOL_MOE; 700
                # and 705 in tconst mode)
                rep["logit_max_err"] = moe_logits_phase(
                    torch, serve, cfg, serve.parse_args(
                        session_argv(mode, layout, "bfloat16")), params)
            elif dtype == "bfloat16" or (mode, layout) == ("tconst",
                                                           "dense"):
                # mamba2: prompts 600 and 605 (10 chunks of 64, the last
                # 24 and 29 rows)
                rep["logit_err"] = logits_phase(
                    torch, serve, cfg, args, params, tol,
                    n_prompts=None if (mode, layout) == ("tconst", "dense")
                    else 2)
                rep["logit_max_err"] = summarize(rep["logit_err"])
            runs[f"{mode}/{layout}/{dtype}"] = rep
            # one model's weights on the card at a time
            params = None
            torch.cuda.empty_cache()
            phase_s[f"{mode}/{layout}/{dtype}"] = time.time() - t_phase
            launched = {n: c["kernel"] for n, c in rep["launches"].items()
                        if c["kernel"]}
            print(f"[serve] {mode}/{layout} {dtype}: launches {launched} "
                  f"(plain 0); logits max err vs the CPU f32 plain path "
                  f"{rep.get('logit_max_err', 'not checked')} (tol "
                  f"{tol}); {time.time() - t_phase:.1f}s")
    print("[serve] f32 greedy session streams match their solo runs on "
          "every layout")
    print(f"[serve] decode state per slot (bf16): tconst/dense "
          f"{runs['tconst/dense/bfloat16']['kv_bytes'] / 2:.0f} B, mamba2 "
          f"{runs['mamba2/dense/bfloat16']['kv_bytes'] / 2:.0f} B")
    print("[launches] the attention LMs' sessions runs: " + "; ".join(
        f"{k}: " + str({n: c["kernel"] for n, c in r["launches"].items()
                        if c["kernel"]})
        for k, r in runs.items()
        if k.split("/")[0] in ("smollm", "full") + MOE_MODES))
    kv_slot = kv_bytes_per_slot(torch, serve, max_len)
    print(f"[serve] KV bytes of one slot at max_len {max_len}, bf16, dense "
          f"layout (DecodeState.kv_bytes, paper Fig 8g): " + ", ".join(
              f"{k} {v}" for k, v in kv_slot.items()))

    # 4b. sliding windows through the models: K1 lo > 0, K3 window > 0
    t_phase = time.time()
    windows = window_phase(torch, runtime, serve)
    phase_s["windows"] = time.time() - t_phase
    for k, v in windows.items():
        print(f"[windows] {k} (f32, reduced; windows {v['windows']}): "
              f"launches {v['launches']}, logits max err vs the CPU f32 "
              f"plain path {v['logit_max_err']:.3g} (tol "
              f"{LOGIT_TOL['float32']}), greedy streams equal the CPU's: "
              f"{v['streams_equal']}; int8 codes adopted from the card: "
              f"{v['codes_adopted']}")
    print(f"[windows] {phase_s['windows']:.1f}s")

    # 5. training at full width: the paper's three variants on one init
    t_phase = time.time()
    training = train_phase(torch, runtime)
    phase_s["train"] = time.time() - t_phase
    for mode, recs in training["runs"].items():
        prof = recs[0]["profile"]
        print(f"[train] {mode} bf16 batch 8 x 1024: losses "
              f"{[round(x, 3) for x in recs[0]['losses']]}; warm step "
              f"{[round(r['warm_step_ms'], 1) for r in recs]} ms (turns), "
              f"{recs[0]['tok_s']:.0f} tok/s, peak "
              f"{max(r['peak_mem_gb'] for r in recs):.2f} GB; one step: "
              f"{prof['launches']} device launches, {prof['device_ms']:.1f} "
              f"device ms, K2 fwd {prof['k2_fwd_calls']} / bwd "
              f"{prof['k2_bwd_calls']} calls, {prof['k2_fwd_ms']:.2f} / "
              f"{prof['k2_bwd_ms']:.2f} device ms")
    t_phase = time.time()
    grads = grad_check_phase(torch, runtime)
    phase_s["train grad check"] = time.time() - t_phase
    for mode, r in grads.items():
        print(f"[train] {mode} gradients at B 1 x 512 vs the CPU f32 plain "
              f"path (rel L2): f32 {r['err_f32']:.2e} (tol {GRAD_TOL_F32}), "
              f"bf16 {r['err_bf16']:.2e} (tol {r['tol_bf16']:.2e} = "
              f"{GRAD_BF16_FACTOR} x the CPU's bf16 {r['err_cpu_bf16']:.2e})")

    # 6. uniform batch engine (bf16): the paper's three variants on one
    # set of weights -- tconst/dense, tlin/paged and the base transformer
    # (full/dense) -- in turns (A, B, C, C, B, A): the host-bound step time
    # drifts between runs
    engines = {}
    for mode, layout in ENGINE_TURNS + ENGINE_TURNS[::-1]:
        t_phase = time.time()
        eargs = serve.parse_args(ENGINE_ARGS + ["--layout", layout])
        ecfg, eapi, eparams = serve.load(eargs, attention_mode=mode)
        erep = serve.run_batch(ecfg, eapi, eparams, eargs)
        check(erep["hit_ms"] is not None and
              (erep["miss_ms"] is not None) == (mode in RESYNCING),
              f"{mode}/{layout} engine run recorded no warm hit, or its "
              f"resyncs are wrong ({erep['n_misses']})")
        done = engines.setdefault(f"{mode}/{layout}", [])
        done.append({k: erep[k] for k in ("hit_ms", "miss_ms", "n_hits",
                                          "n_misses", "miss_samples_ms",
                                          "seconds")})
        phase_s[f"engine {mode}/{layout} #{len(done)}"] = \
            time.time() - t_phase
    print(f"[engine] bf16 batch {eargs.batch}, max_len "
          f"{serve.batch_max_len(eargs)}, runs in turns A B C C B A: " +
          "; ".join(f"{k} cache-hit step "
                    f"{[round(r['hit_ms'], 3) for r in v]} ms, resync "
                    f"{[r['miss_ms'] and round(r['miss_ms'], 3) for r in v]}"
                    f" ms" for k, v in engines.items()))
    t_phase = time.time()
    sargs = serve.parse_args(SSM_ENGINE_ARGS)
    scfg, sapi, sparams = serve.load(sargs)
    srep = serve.run_batch(scfg, sapi, sparams, sargs)
    check(srep["hit_ms"] is not None and srep["n_misses"] == 0,
          f"mamba2 engine run: no warm step, or a resync ({srep['n_misses']})")
    engines["mamba2/dense"] = [{k: srep[k] for k in (
        "prefill_ms", "hit_ms", "n_hits", "seconds")}]
    phase_s["engine mamba2/dense"] = time.time() - t_phase
    print(f"[engine] mamba2 bf16 batch {sargs.batch}, prompt "
          f"{sargs.prompt_len} (K4 at Q = 64): step "
          f"{srep['hit_ms']:.3f} ms (mean of {srep['n_hits']}), admission "
          f"(prefill of the batch) {srep['prefill_ms']:.3f} ms")

    # 7. report
    line = []
    for name, (case, src, repl, run) in KERNELS.items():
        # the bf16 row of the representative case
        r = min((x for x in rows if x["kernel"] == name and
                 x["case"] == case), key=lambda x: x["dtype"] != "bfloat16")
        launched = training["runs"][run[1]][0]["launches"] \
            if run[0] == "train" else {
                n: c["kernel"] for n, c in
                runs[f"{run[0]}/{run[1]}/bfloat16"]["launches"].items()}
        line.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launched[name],
            "max_abs_err": max(x["max_abs_err"] for x in rows
                               if x["kernel"] == name),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    detail = {
        "card": card, "kind": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": built,
        "kernel_rows": rows, "sass_tensor_core_ops": sass,
        "launches_per_call": per_call, "sessions": runs, "engines": engines,
        "training": training, "grad_check": grads,
        "phase_s": phase_s, "total_s": time.time() - t_start,
    }
    (OUT / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(f"[done] {time.time() - t_start:.1f}s "
          f"({ {k: round(v, 1) for k, v in phase_s.items()} })")
    print(card)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
