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
   (``--sessions 4 --prompt-len 600 --gen 192 --chunk 32``), each run's
   launch counters reset before the scheduler and read right after it:
   tconst on the dense layout (the first slice's main path, bf16 and f32)
   and, in bf16 and f32, TLinFormer on the paged and paged_int8 layouts
   (3 slots, a pool of 31 pages of 64 below the full 42, so an admission
   waits for pages a finished session frees while two sessions decode)
   and tconst on the int8 layout.  Each run must launch exactly its
   kernels (K3 on the paged runs, K1-int8 on the int8 runs) and no plain
   version.  f32 greedy streams must equal their solo runs on the same
   layout (the f32 runs use ``--prompt-len 700 --gen 96``: every session
   still crosses a resync).  bf16 logits after the
   prefill and after a few decode steps are held against the f32 plain
   path on the CPU, same layout.  mamba2-130m's f32 run (streams only)
   is cut to 6 of its 24 layers.  The runs of the families without a
   resync (mamba2, the attention LMs, deepseek) generate 96 tokens
   where no f32 argv below applies (``--gen 96``: a paged run's third
   session still waits for pages).  Then the dense attention LMs at
   full width: smollm-360m (32 layers, d 960, 15 heads over 5 KV heads)
   on the dense layout (K1, K2) and the paged one (K2, K3), and the
   paper's base transformer (tconst-41m in full attention, on the
   tconst weights) on int8 (K1-int8, K2) and paged_int8 (K2, K3-int8),
   same argv, bf16 and f32 (f32 at ``--prompt-len 700 --gen 72``,
   smollm at 8 of its 32 layers); their bf16 logits held at 3x the CPU
   plain path's own bf16 error.  Then the MoE
   family: deepseek-moe-16b (16.4 B parameters, drawn on the card in bf16
   from a seed) at full width and depth on dense (K1, K2) and paged (K2,
   K3, the under-sized pool) in bf16 (``--gen 64``; finite logits), and
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
   A prefix-sharing phase serves the same argv with ``--prefix-sharing``
   (prompts: one system prompt of 600 tokens plus an 8-token tail each,
   admitted up front; f32 at 700 + 8): TLinFormer on paged and paged_int8
   (bf16 and f32, pools of 30 and 31 pages: 8 shared pages of 64, and
   the fork reserve lets two sessions in and makes the third wait) and
   smollm-360m
   on paged (bf16 at full depth, f32 at 8 of 32 layers, pools of 16: 9
   and 10 shared pages, no reserve).  Each run must share at
   least one page after the first admissions, hold fewer assigned KV
   bytes than the same admissions without sharing, leave every page that
   is shared when a decode chunk starts bit-identical through it (read
   on the card, every chunk), fork at least its shared pages before a
   resync (TLinFormer; smollm forks none), launch exactly its layout's
   kernels and no plain version, match its solo runs in f32, and end
   with every refcount 0, the prefix map empty and every page free.
   A chunked-admission phase (4c) serves smollm-360m on paged with
   ``--prefix-sharing --prefill-chunk 128`` (f32: 4b's argv; bf16 at gen
   32 on a pool of 14): the cold admissions forward their prompt padded
   to the chunk grid, each sharer its tail plus one chunk at most, and
   no admission writes a resident prefix page (read back on the card);
   tconst-41m on dense and TLinFormer on paged_int8 with
   ``--prefill-chunk 64`` (the bucketed admission: max_len forwarded;
   bf16 logits through it against the CPU f32 plain path); mamba2-130m
   in f32 at 6 layers in chunks of 64 (K4 once a layer a chunk, from the
   carried state).  Each run launches exactly its kernels, no plain
   version; f32 streams equal the same argv's one-shot run.  It also
   profiles smollm's bf16 admission of a 608-token prompt: one-shot,
   chunked cold and chunked sharing (tokens forwarded, device launches,
   device ms, K2's device ms, wall ms).  K2 at the chunk shape (64
   queries at 576 and 960 over keys ``[0, start + 64)``; smollm's and
   deepseek's heads, one case under a 256 window) is a case of phase 3,
   with SDPA under a lower-right causal mask as its yardstick.
   A window phase serves reduced gemma3 (6 layers: 5 local : 1 global),
   tconst-41m in sliding mode (window 8, 8 layers) and reduced mixtral
   (window 8, two MoE layers, G 4) on all four layouts in f32: K1 with
   ``lo > 0`` and K3 with ``window > 0`` through a model; and reduced
   deepseek in tconst mode, mixtral in tlin mode (MoE FFNs in the TConst
   core, W 8: resyncs inside the logit checks) and minicpm-2b the same
   way.  The card's logits against the CPU plain path's, the streams
   equal on the float layouts.  gemma3 and mixtral run again on the card
   with ``--prefill-chunk 16`` on every layout: the streams equal its
   one-shot run's.
   A tiering phase (4e) serves sessions beyond the slots through a tier
   store (``--spill-capacity-mb``: a slot that decoded a chunk spills to
   the host while sessions wait, and resumes into any free slot):
   tconst-41m on dense (6 sessions over 2 slots, prompts 700-725, gen 96,
   bf16 and f32; f32 again on a 1 MiB RAM tier over a disk tier, every put
   demoted), TLinFormer on paged_int8 (4b's f32 argv, 6 sessions over 3
   slots, gen 96) and smollm-360m on paged with sharing and chunks of 128
   over one slot, so that every spill retires the system prompt's pages
   into the store and the next admission re-adopts them and forwards one
   chunk (f32 at 8 layers; bf16 at full depth, gen 32 in chunks of 16).
   Each run launches exactly its kernels, no plain version; every excess
   session completes a spill->resume cycle, resumes forward nothing, the
   spilled bytes equal each spill's live state (``snapshot_bytes``), a
   TConst session resyncs as often as untiered, and the f32 streams equal
   the untiered runs and the solo runs.  Then the O(1) re-admission of a
   tconst-41m prompt of 1024 and 8192 tokens (bf16; f32 at 1024): a
   cold admission, then the same prompt in a fresh scheduler on the same
   store, which must restore (0 tokens forwarded) with no kernel launch
   and no GEMM (a restore alone traces copies only) and the cold
   admission's logits bit for bit; device ms, wall ms and snapshot bytes
   of both.
   A workload phase (4f) replays seeded traffic traces open-loop
   (``serve.drive``) under both scheduling policies with telemetry: (a)
   ``serve.main`` with ``--workload bursty --policy slo`` at full width
   (tconst-41m, 8 sessions over 2 slots, chunks of 4): rc 0, every
   session finished, K1 and K2 only; (b) tconst-41m / dense, 12 bursty
   sessions over 3 slots in chunks of 32 (prompts 700-1000, outputs
   48-144, a quarter repeats, temperature 0.7, the bucketed admission, a
   RAM tier store, a spill of every slot that decoded a chunk while
   sessions wait), f32 and bf16 under ``fifo`` and ``slo``; (c)
   smollm-360m / paged at 8 layers in f32, 10 sessions behind one 4-page
   system prompt, prefix sharing, chunked admission in chunks of 128 and
   a pool of 20 pages of 64, both policies.  Each run launches exactly its
   layout's kernels and no plain version, drains every session, resumes
   every spill and leaves no pin (paged: every page free); the f32 streams
   are equal across the policies at every trace position, and every f32
   run's numbers in chunk units (TTFT, inter-token gaps, queue waits,
   SLO attainment, spills, resumes, admission sources and forward tokens,
   deferrals, the final clock) equal ``tools/torch_workload_counts.py``'s
   prediction (``WORKLOAD_PREDICTION``).  In (c) the slo policy must
   consult ``defer_admission`` and weigh victims whose ``spill_cost``
   varies with their live pages and has a re-admission term.  Prints each
   run's summary, warm TTFT seconds beside the card line, and slo against
   fifo SLO attainment (recorded, not gated).
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
6. Uniform-batch Engine (``--batch 4 --prompt-len 1024 --gen 288``): the
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

# gen 192 (six chunks): every session crosses a resync (g0 88-103 of
# W_og 256), and the smoke stays clear of its limit on a slow host
SESSIONS_ARGS = ["--sessions", "4", "--slots", "2", "--prompt-len", "600",
                 "--gen", "192", "--chunk", "32"]
# the kernel phase's and the KV-bytes line's max_len: the sessions argv's
# at gen 320 (615 + 320 + 64), the shapes the kernel table records
KERNEL_MAX_LEN = 999
SSM = "mamba2_130m"
SMOLLM = "smollm-360m"
DEEPSEEK = "deepseek_moe_16b"
MINICPM = "minicpm_2b"
# deepseek's f32 runs and its logit checks: the dense layer and two MoE
# layers at full width (the only cut: 16.4 B parameters are 65.6 GB in
# f32, and the CPU reference reads every expert's weights each step)
DEEPSEEK_CHECK_DEPTH = 3
# the bf16 runs of the families without a resync (the attention LMs and
# mamba2) at full depth: gen 96 (three chunks), so each
# session but the last decodes while the next is admitted, and a paged
# run's third session waits for pages (12 + 12 of 31 held).  Their
# eager steps are host-bound (30-70 ms a step at full depth): gen 320
# made smollm's two runs alone ~110 s of the smoke on a slow host
LM_BF16_ARGS = ["--gen", "96"]
# deepseek's bf16 runs (~110 ms a step at full depth): gen 64 (two
# chunks); the paged run's pool of 23 pages (11 + 11 held, 12 needed)
# makes a session wait for pages, as 31 does at gen 96
DEEPSEEK_BF16_ARGS = ["--gen", "64"]
DEEPSEEK_BF16_POOL = ["--pool-pages", "23"]
LM_MODES = ("smollm", "full", "mamba2", "deepseek")
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
# paged runs: 3 slots, a pool below the full 3 x 14 pages: sessions need
# 13, 13, 14, 14 pages of 64 (prompt + gen + one chunk), so two decode
# together and the third waits for pages with a slot free
PAGED_ARGS = ["--slots", "3", "--page-size", "64", "--pool-pages", "31"]
# f32 runs of the TConst core: shorter, every session still crosses a
# resync (g0 = 188..203 of W_og = 256); paged pool 27 of 3 x 14 pages
F32_ARGS = ["--prompt-len", "700", "--gen", "96"]
F32_PAGED_ARGS = ["--slots", "3", "--page-size", "64", "--pool-pages", "27"]
# f32 runs of the dense LMs (no resync to cross): gen 72, the shortest at
# which the first session still decodes when the third arrives, so the
# paged pool of 27 makes it wait (13 + 13 pages held)
F32_LM_ARGS = ["--prompt-len", "700", "--gen", "72"]
# gen 288 from a 1024-token prompt: two resyncs (steps 1 and 257), the
# second warm (544 before the tiering phase came: three resyncs)
ENGINE_ARGS = ["--arch", "tconst-41m", "--batch", "4", "--prompt-len",
               "1024", "--gen", "288"]
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
# the prefix-sharing phase: sessions whose prompts are one system prompt of
# --prompt-len tokens plus an 8-token tail each, admitted up front.
# TLinFormer: a 608-token prompt's stable prefix is 512 tokens (the last
# 96 sit in the window), 8 shared pages of 64; a session takes 13 pages
# (f32: 14), and an adoption reserves a page for each page it will fork,
# so a pool of 30 (f32: 31) admits two sessions and makes the third wait
# (bf16 at the sessions argv's gen 192 since PR 25; 320 and a pool of 31
# before, the same pattern of waits).  smollm:
# the whole prompt is stable, but a page that holds a tail token is not
# shared: 9 shared pages of 12 (gen 96; f32: 10 of 13), no reserve (an LM
# never forks): a pool of 16 holds two sessions, not three
SHARING_RUNS = [("tlin", "paged"), ("tlin", "paged_int8"),
                ("smollm", "paged")]
SHARING_POOL = {("tlin", "bfloat16"): 30, ("tlin", "float32"): 31,
                ("smollm", "bfloat16"): 16, ("smollm", "float32"): 16}
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
# the chunked-admission phase (4c): the 4b and phase-4 argv with chunks.
# smollm on paged with --prefix-sharing --prefill-chunk 128 (4b's prompts
# 600 + 8; f32 700 + 8 at 8 layers and 4b's argv): a cold admission
# forwards its prompt padded to the chunk grid (640; f32 768), a sharer
# one chunk (bf16: 9 adopted pages, resident 576, the loop starts at 512
# and sends its write of adopted page 8 to TRASH; f32: 10 adopted, start
# 640).  bf16 at gen 32 (admission is the path) on a pool of 14: 11 pages
# a session, so two admit together and the third waits for pages.
# tconst-41m / dense and TLinFormer / paged_int8 with --prefill-chunk 64:
# the bucketed admission (forwards max_len), at F32_ARGS in both dtypes,
# so every session crosses a resync.  mamba2 / dense in f32 at 6 layers:
# 10 chunks of 64 a prompt, K4 from the carried state.  Each f32 run
# shares its argv with a phase-4 / 4b run and is held to that run's
# streams (checked there against the solo runs).
SHARING_CHUNK_BF16 = ["--gen", "32", "--pool-pages", "14"]
SHARING_CHUNK = 128
BUCKET_CHUNK = 64
CHUNKED_RUNS = [("smollm", "paged", ("bfloat16", "float32")),
                ("tconst", "dense", ("bfloat16", "float32")),
                ("tlin", "paged_int8", ("bfloat16", "float32")),
                ("mamba2", "dense", ("float32",))]
# the window phase's chunked runs (card only, streams against the card's
# one-shot runs): chunks of one page, a per-layer window on K2's chunk
# shape and MoE routing per chunk
WINDOW_CHUNK_MODELS = ("gemma3", "mixtral")
WINDOW_CHUNK = 16
# the tiering phase (4e): sessions beyond the slots, a tier store and a
# spill of every slot that decoded a chunk while sessions wait.  Run 1:
# tconst-41m / dense, 6 sessions over 2 slots at phase 4's f32 argv (prompts
# 700 + 5i, gen 96, max_len 875 as phase 4's: every session crosses a
# resync) in bf16 and f32; run 5 is its f32 argv on a 1 MiB RAM tier over
# a disk tier (a tconst snapshot is larger, so every put demotes).  Run 2:
# TLinFormer / paged_int8 at 4b's f32 argv in both dtypes (prompts 700 +
# 8, gen 96, a pool of 31), 6 sessions over 3 slots.  Run 3: smollm /
# paged with sharing and chunks of 128 over ONE slot, so every spill drops
# the prefix pages to refcount 0 and they retire: f32 at 8 layers (4b's
# argv, 3 sessions), bf16 at full depth at 4c's gen 32 with chunks of 16
# tokens (so that a session decodes past its first chunk and spills), each
# on the full pool of its one slot.  Run 4: the O(1) re-admission of
# TIER_READMIT_N-token prompts.
TIER_ARGS = ["--sessions", "6", "--spill-capacity-mb", "64"]
TIER_DENSE_ARGS = F32_ARGS + ["--max-len", "875"] + TIER_ARGS
TIER_DISK_ARGS = ["--spill-capacity-mb", "1", "--spill-dir",
                  str(OUT / "tier_spill")]
TIER_PAGED_ARGS = F32_ARGS + ["--pool-pages", "31"] + TIER_ARGS
TIER_SMOLLM_ARGS = ["--sessions", "3", "--slots", "1", "--pool-pages", "0",
                    "--prefill-chunk", str(SHARING_CHUNK),
                    "--spill-capacity-mb", "256"]
TIER_SMOLLM_BF16 = ["--gen", "32", "--chunk", "16"]
TIER_READMIT_N = (1024, 8192)
TIER_READMIT_GEN = 16
# the workload phase (4f): seeded traces replayed open-loop under both
# scheduling policies (``serve.drive``).  (a) the launcher's --workload
# mode at full width with the verify skill's argv.  (b) tconst-41m /
# dense, 3 slots, chunks of 32, a RAM tier store and a spill of every
# slot that decoded a chunk while sessions wait: 12 bursty sessions,
# prompts 700-760 or 960-1000 (g0 188-248 / 192-232 of W_og 256) and
# outputs of 48-80 or 112-144 tokens, so most sessions cross a resync; a
# quarter repeat an earlier prompt (an O(1) store re-admission), 40% carry
# a TTFT deadline of 3 chunks; temperature 0.7; the bucketed admission
# (--prefill-chunk 64: one signature, so a TTFT past the first admission
# is warm; one-shot admissions would taint every distinct prompt length).
# (c) smollm-360m / paged (f32 at SMOLLM_F32_DEPTH layers) with prefix
# sharing and chunked admission in chunks of 128, pages of 64, a pool of
# 20 below the full 3 x 13: 10 bursty sessions, 60% of them behind one
# 4-page system prompt, so the slo policy defers admissions for
# page-blocked deadline sessions, and weighs its victims by live pages.
# Every number of a run in chunk units is a function of the trace and
# the schedule (no EOS): predicted on the CPU by
# tools/torch_workload_counts.py (WORKLOAD_PREDICTION below) and held to
# on the card in f32.
WORKLOAD_CLI_ARGS = ["--arch", "tconst-41m", "--sessions", "8", "--slots",
                     "2", "--chunk", "4", "--max-len", "104", "--workload",
                     "bursty", "--policy", "slo", "--slo-ttft-chunks", "6"]
WORKLOAD_STORE_BYTES = 8 << 30       # ample: no eviction shapes a schedule
WORKLOAD_POLICIES = ("fifo", "slo")
WORKLOAD_RUNS = {
    "tconst/dense": dict(
        mode="tconst", layout="dense", slots=3, chunk=32, max_len=1200,
        prefill_chunk=BUCKET_CHUNK, seed=3, dtypes=("float32", "bfloat16"),
        spec=dict(n_sessions=12, arrival="bursty", burst_size=4,
                  burst_every=3.0,
                  prompt_mix=((0.6, 700, 760), (0.4, 960, 1000)),
                  output_mix=((0.7, 48, 80), (0.3, 112, 144)),
                  repeat_frac=0.25, slo_frac=0.4, slo_ttft_chunks=3,
                  temperature=0.7)),
    "smollm/paged": dict(
        mode="smollm", layout="paged", slots=3, chunk=32, max_len=832,
        page=64, pool=20, prefill_chunk=SHARING_CHUNK, prefix_sharing=True,
        seed=1, dtypes=("float32",),
        spec=dict(n_sessions=10, arrival="bursty", burst_size=4,
                  burst_every=3.0, shared_frac=0.6, n_prefixes=1,
                  prefix_len=256,
                  prompt_mix=((0.7, 64, 192), (0.3, 256, 384)),
                  output_mix=((0.8, 32, 64), (0.2, 96, 128)),
                  repeat_frac=0.1, slo_frac=0.4, slo_ttft_chunks=2,
                  temperature=0.7)),
}
# tools/torch_workload_counts.py's output (its chunk-unit numbers of each
# run and policy, on the CPU at reduced widths)
WORKLOAD_PREDICTION = {
    "tconst/dense/fifo": {"sessions": 12,
                          "finished": 12,
                          "tokens_out": 1000,
                          "ttft_chunks": {"p50": 2.0, "p99": 3.0},
                          "itl_chunks": {"p50": 0.0, "p99": 4.0},
                          "queue_wait_chunks": {"p50": 2.0, "p99": 3.0},
                          "slo": {"sessions_with_slo": 6,
                                  "attainment": 1.0,
                                  "ttft_attainment": 1.0},
                          "spills": 21,
                          "resumes": 21,
                          "ttft_compile_excluded": 2,
                          "clock": 15,
                          "sources": ["cold", "cold", "cold", "cold", "cold",
                                      "cold", "cold", "store", "cold", "cold",
                                      "cold", "cold", "resume", "resume",
                                      "resume", "resume", "resume", "resume",
                                      "resume", "resume", "resume", "resume",
                                      "resume", "resume", "resume", "resume",
                                      "resume", "resume", "resume", "resume",
                                      "resume", "resume", "resume"],
                          "forward_tokens": [1200, 1200, 1200, 1200, 1200,
                                             1200, 1200, 0, 1200, 1200, 1200,
                                             1200, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                             0],
                          "deferrals": [0, 0],
                          "crossed_resync": 12},
    "tconst/dense/slo": {"sessions": 12,
                         "finished": 12,
                         "tokens_out": 1000,
                         "ttft_chunks": {"p50": 3.0, "p99": 7.0},
                         "itl_chunks": {"p50": 0.0, "p99": 2.0},
                         "queue_wait_chunks": {"p50": 3.0, "p99": 7.0},
                         "slo": {"sessions_with_slo": 6,
                                 "attainment": 1.0,
                                 "ttft_attainment": 1.0},
                         "spills": 21,
                         "resumes": 21,
                         "ttft_compile_excluded": 2,
                         "clock": 16,
                         "sources": ["cold", "cold", "cold", "cold", "resume",
                                     "resume", "resume", "resume", "resume",
                                     "store", "cold", "cold", "resume",
                                     "resume", "cold", "resume", "resume",
                                     "cold", "cold", "resume", "cold",
                                     "resume", "cold", "resume", "resume",
                                     "resume", "resume", "resume", "resume",
                                     "resume", "resume", "resume", "resume"],
                         "forward_tokens": [1200, 1200, 1200, 1200, 0, 0, 0,
                                            0, 0, 0, 1200, 1200, 0, 0, 1200,
                                            0, 0, 1200, 1200, 0, 1200, 0,
                                            1200, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                            0],
                         "deferrals": [0, 15],
                         "crossed_resync": 12},
    "smollm/paged/fifo": {"sessions": 10,
                          "finished": 10,
                          "tokens_out": 718,
                          "ttft_chunks": {"p50": 1.0, "p99": 4.0},
                          "itl_chunks": {"p50": 0.0, "p99": 4.0},
                          "queue_wait_chunks": {"p50": 1.0, "p99": 4.0},
                          "slo": {"sessions_with_slo": 5,
                                  "attainment": 0.6,
                                  "ttft_attainment": 0.6},
                          "spills": 15,
                          "resumes": 15,
                          "ttft_compile_excluded": 2,
                          "clock": 15,
                          "sources": ["cold", "cold", "cold", "cold",
                                      "resume", "cold", "resume", "cold",
                                      "cold", "cold", "cold", "resume",
                                      "resume", "resume", "resume", "resume",
                                      "resume", "cold", "resume", "resume",
                                      "resume", "resume", "resume", "resume",
                                      "resume"],
                          "forward_tokens": [640, 384, 128, 384, 0, 256, 0,
                                             128, 384, 128, 256, 0, 0, 0, 0,
                                             0, 0, 128, 0, 0, 0, 0, 0, 0, 0],
                          "deferrals": [0, 6],
                          "crossed_resync": 0},
    "smollm/paged/slo": {"sessions": 10,
                         "finished": 10,
                         "tokens_out": 718,
                         "ttft_chunks": {"p50": 1.0, "p99": 6.0},
                         "itl_chunks": {"p50": 0.0, "p99": 2.0},
                         "queue_wait_chunks": {"p50": 1.0, "p99": 6.0},
                         "slo": {"sessions_with_slo": 5,
                                 "attainment": 1.0,
                                 "ttft_attainment": 1.0},
                         "spills": 16,
                         "resumes": 16,
                         "ttft_compile_excluded": 2,
                         "clock": 16,
                         "sources": ["cold", "cold", "resume", "cold", "cold",
                                     "cold", "resume", "cold", "resume",
                                     "resume", "resume", "cold", "resume",
                                     "cold", "resume", "cold", "resume",
                                     "resume", "resume", "cold", "resume",
                                     "resume", "resume", "resume", "resume",
                                     "resume"],
                         "forward_tokens": [640, 384, 0, 384, 256, 128, 0,
                                            128, 0, 0, 0, 128, 0, 384, 0, 128,
                                            0, 0, 0, 256, 0, 0, 0, 0, 0, 0],
                         "deferrals": [4, 19],
                         "crossed_resync": 0}}
# device items of a restore (host <-> device and device copies), and the
# names cuBLAS gives its GEMM kernels
RESTORE_RE = "copy|memcpy|memset|fill"
GEMM_RE = "gemm|xmma|cutlass|nvjet|wgmma"
# the aten ops a restore may dispatch: data movement, views and the
# allocation of its padding (no arithmetic)
RESTORE_OPS_RE = ("^(copy_|_to_copy|lift_fresh|slice|select|view|detach|"
                  "alias|empty|new_zeros|zeros|cat|index_put_|"
                  "_local_scalar_dense)$")
# aten ops of a matrix product or an attention
GEMM_OPS_RE = "mm|matmul|linear|conv|einsum|attention"

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


def sdpa_k2(torch, q, k, v, mask, square_causal=False, window=0):
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


def sdpa_chunk(torch, q, k, v, mask, square_causal=False, window=0):
    """SDPA at a chunk's shape: C queries over keys ``[0, start + C)``,
    the KV heads expanded to the query heads (before the timed call), a
    lower-right causal mask (``causal_lower_right``, which the fused
    kernels take) or, under a window, the boolean mask."""
    import torch.nn.functional as F
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    if window:
        m = mask[:, None]
    else:
        from torch.nn.attention.bias import causal_lower_right
        m = causal_lower_right(q.shape[1], k.shape[1])
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m)


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
            cases=None, library=sdpa_k2):
    """K2 against its plain version at the resync / admission shapes
    (``cases``: (label, q_pos, k_pos, causal[, window]), default
    :func:`k2_cases`; ``library``: makes the SDPA yardstick's call)."""
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
                   library(torch, q, k, v, mask, square, window),
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


def chunk_rows(torch, rows, dev, randn, dname: str):
    """K2 at a chunked admission's shape: one batch-1 chunk of 64 queries
    at positions ``[start, start + 64)``, start 576 and 960 of a 1088-slot
    row, over its live keys ``[0, start + 64)``, at smollm-360m's heads
    (15 over 5, D 64; and one case under a 256 window) and at
    deepseek-moe-16b's (16 over 16, D 128); SDPA over the same keys with
    a lower-right causal mask as the yardstick."""
    from repro_torch.config import get_config

    def chunk(prefix, start, window=0):
        qp = start + torch.arange(64, dtype=torch.int32, device=dev)[None]
        kp = torch.arange(start + 64, dtype=torch.int32, device=dev)[None]
        label = f"{prefix}_chunk_{start}" + (f"_w{window}" if window else "")
        return (label, qp, kp, True) + ((window,) if window else ())

    k2_rows(torch, rows, get_config(SMOLLM), dev, randn, dname, 1088,
            cases=[chunk("smollm", 576), chunk("smollm", 960),
                   chunk("smollm", 960, 256)], library=sdpa_chunk)
    k2_rows(torch, rows, get_config(DEEPSEEK), dev, randn, dname, 1088,
            cases=[chunk("deepseek", 576), chunk("deepseek", 960)],
            library=sdpa_chunk)


def kernel_phase(torch, cfg, dev, max_len: int):
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    parts_s = {}

    def timed(fn, *args):
        t0 = time.time()
        fn(*args)
        parts_s[fn.__name__] = parts_s.get(fn.__name__, 0) + time.time() - t0

    for dname in ("bfloat16", "float32"):
        timed(k1_rows, torch, rows, cfg, dev, randn, gen, dname, max_len)
        timed(k3_rows, torch, rows, cfg, dev, randn, gen, dname, max_len)
        timed(k2_rows, torch, rows, cfg, dev, randn, dname, max_len)
        timed(lm_rows, torch, rows, dev, randn, gen, dname, max_len)
        timed(chunk_rows, torch, rows, dev, randn, dname)
        timed(k2_bwd_rows, torch, rows, cfg, dev, randn, dname)
    timed(ssd_phase, torch, rows, dev, gen)
    print("[kernel] seconds by row group: " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts_s.items()))
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
    """The launcher's argv of one sessions run (f32 runs of the TConst
    core at the shorter F32_ARGS (tconst/dense's too), of
    the dense LMs and deepseek at F32_LM_ARGS; the other runs of
    ``LM_MODES`` at LM_BF16_ARGS, deepseek's at DEEPSEEK_BF16_ARGS and
    DEEPSEEK_BF16_POOL; deepseek in tconst mode at F32_ARGS in both
    dtypes)."""
    argv = SESSIONS_ARGS + ["--arch", MODELS[mode][0], "--dtype", dtype,
                            "--layout", layout]
    if mode == "deepseek-tconst":
        argv += F32_ARGS
    elif dtype == "float32" and mode in ("smollm", "full", "deepseek"):
        argv += F32_LM_ARGS
    elif dtype == "float32" and mode in TCONST_MODES:
        argv += F32_ARGS
    elif mode == "deepseek":
        argv += DEEPSEEK_BF16_ARGS
    elif mode in LM_MODES:
        argv += LM_BF16_ARGS
    if layout.startswith("paged"):
        argv += F32_PAGED_ARGS if dtype == "float32" else PAGED_ARGS
        if (mode, dtype) == ("deepseek", "bfloat16"):
            argv += DEEPSEEK_BF16_POOL
    return argv


def sharing_argv(mode: str, layout: str, dtype: str):
    """A sessions run's argv with ``--prefix-sharing`` and the pool of
    ``SHARING_POOL``."""
    argv = session_argv(mode, layout, dtype)
    return argv + ["--prefix-sharing", "--pool-pages",
                   str(SHARING_POOL[mode, dtype])]


@contextlib.contextmanager
def cow_watch(torch):
    """While active, every decode chunk of a prefix-sharing scheduler is
    checked on the card: the pool pages at refcount > 1 when the chunk
    starts (after the scheduler's copy-on-write pass, which names the
    scheduler to the watch) must come out of it bit-identical.  So must,
    through every admission, the pages of the prefix map that live
    sessions hold (adopted or not, an admission writes none of them).
    Yields the record (chunks, chunks with shared pages, pages checked;
    admissions, the pages each adopted, resident pages checked)."""
    import numpy as np
    from repro_torch.serving import scheduler as S
    orig, orig_cow = S.decode_chunk, S.SlotScheduler._cow_before_chunk
    orig_admit = S.SlotScheduler._admit
    rec = {"chunks": 0, "chunks_with_shared": 0, "pages_checked": 0,
           "adopted": [], "resident_pages_checked": 0}

    def cow(sched):
        rec["sched"] = sched
        return orig_cow(sched)

    def admit(sched, session, slot, plan):
        resident = [p for p in sched._page_key if sched._page_ref[p] > 0]
        idx = torch.as_tensor(resident, dtype=torch.long,
                              device=sched.device)
        before = sched.layout.gather_pages(sched.state.kv, idx)
        orig_admit(sched, session, slot, plan)
        after = sched.layout.gather_pages(sched.state.kv, idx)
        check(all(torch.equal(after[f], v) for f, v in before.items()),
              f"an admission wrote a resident prefix page (of {resident})")
        rec["adopted"].append(len(plan["adopted"]))
        rec["resident_pages_checked"] += len(resident)

    def watched(decode, params, state, *a, **kw):
        sched = rec["sched"]
        shared = np.nonzero(sched.page_refcounts() > 1)[0]
        idx = torch.as_tensor(shared, device=sched.device)
        before = sched.layout.gather_pages(state.kv, idx)
        out = orig(decode, params, state, *a, **kw)
        after = sched.layout.gather_pages(out[1].kv, idx)
        check(all(torch.equal(after[f], v) for f, v in before.items()),
              f"a decode chunk wrote a shared page (of {list(shared)})")
        rec["chunks"] += 1
        rec["chunks_with_shared"] += bool(len(shared))
        rec["pages_checked"] += len(shared)
        return out

    S.decode_chunk, S.SlotScheduler._cow_before_chunk = watched, cow
    S.SlotScheduler._admit = admit
    try:
        yield rec
    finally:
        S.decode_chunk, S.SlotScheduler._cow_before_chunk = orig, orig_cow
        S.SlotScheduler._admit = orig_admit


def serve_phase(torch, runtime, serve, mode: str, layout: str, dtype: str,
                kernels, sharing: bool = False, extra=(), ref_streams=None,
                **overrides):
    """One sessions run of the main path: counters reset right before
    the scheduler, read right after it; then the checks: exactly
    ``kernels`` launch (None: ``layout_kernels``), no plain version.
    ``sharing``: the run with ``--prefix-sharing`` (``sharing_argv``),
    its chunks and admissions under :func:`cow_watch`.  ``extra``: argv
    appended (``--prefill-chunk``).  ``ref_streams``: the streams of a
    run of the same argv whose streams were held to their solo runs; an
    f32 run is then held to them instead of running its own solo runs.
    ``overrides`` replace config fields of the run's model (deepseek's
    depth)."""
    args = serve.parse_args((sharing_argv if sharing else session_argv)(
        mode, layout, dtype) + list(extra))
    t0 = time.time()
    cfg, api, params = serve.load(args, **MODELS[mode][1], **overrides)
    torch.cuda.synchronize()
    parts_s = {"load": time.time() - t0}
    with (cow_watch(torch) if sharing else contextlib.nullcontext()) \
            as watch:
        runtime.reset_counters()
        served = serve.serve_sessions(cfg, api, params, args)
        torch.cuda.synchronize()
        counts = runtime.read_counters()
    sched = served["sched"]
    what = f"{mode}/{layout} {dtype} sessions"
    if kernels is None:
        kernels = layout_kernels(cfg, layout)
    check(set(kernels) <= set(counts), f"{what}: a kernel of {kernels} "
          f"has no counter ({counts})")
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
    rep = {"seconds": served["seconds"], "parts_s": parts_s,
           "launches": counts,
           "page_waits": sched.page_waits, "peak_active": sched.peak_active,
           "kv_bytes": sched.kv_bytes(),
           "streams": [list(s.tokens) for s in served["sessions"]],
           "forward_tokens": [s.forward_tokens for s in sched.admit_stats]}
    if sharing:
        share = served["sharing"]
        check(share["shared"] >= 1, f"{what}: no page was shared after the "
              f"first admissions ({share})")
        check(share["assigned_kv_bytes"] < share["unshared_kv_bytes"],
              f"{what}: sharing saved no assigned KV bytes ({share})")
        check(watch["chunks_with_shared"] >= 1, f"{what}: no chunk ran "
              f"with shared pages ({watch})")
        resyncing = mode in RESYNCING
        check((sched.pages_forked >= share["shared"]) if resyncing
              else sched.pages_forked == 0, f"{what}: {sched.pages_forked} "
              f"pages forked for {share['shared']} shared")
        check(not sched.page_refcounts().any() and not sched._prefix_map,
              f"{what}: refcounts or prefix map left after the run")
        rep.update(sharing=share, cow_watch={k: v for k, v in watch.items()
                                             if k != "sched"},
                   adopted=watch["adopted"],
                   pages_forked=sched.pages_forked,
                   fork_pauses=sched.fork_pauses)
    # the solo runs the streams are checked against come after the read
    if ref_streams is not None:
        rep["streams_equal_ref"] = rep["streams"] == ref_streams
        check(dtype != "float32" or rep["streams_equal_ref"], f"{what}: "
              f"f32 greedy streams differ from the same argv's run "
              f"without {list(extra)}")
    elif dtype == "float32":
        t0 = time.time()
        chk = serve.check_sessions(api, params, served, args)
        parts_s["solo"] = time.time() - t0
        rep["sessions"] = [{k: s[k] for k in ("sid", "prompt_len",
                                              "resyncs", "matches")}
                           for s in chk["sessions"]]
        check(chk["rc"] == 0 and all(s["matches"] for s in chk["sessions"]),
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
                 device="cuda", ref=None, chunk=None):
    """Logits of session prompts on the card (kernels) against the plain
    path on the CPU in f32, same weights and layout (full pool): the
    first token (the admission: K2, or K4 for mamba2) and
    ``LOGIT_STEPS`` cache-hit steps after it (K1 / K1-int8 / K3; mamba2's
    plain recurrent step), both fed the reference's greedy tokens.
    ``tol``: the largest error allowed; ``ref``: a
    :func:`cpu_reference` of these weights to reuse; ``chunk``: the card
    admits through ``prefill_into_slot_chunked`` at that chunk (a TConst
    model: the bucketed admission) into a one-slot state, against the
    reference's one-shot prefill.  Each record counts the routed tokens
    (token x MoE layer) and those whose expert set differs from the
    reference's."""
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
                if step == 0 and chunk:
                    got, st, _ = card_dec.prefill_into_slot_chunked(
                        card_params, card_dec.init_state(1, max_len), 0, p,
                        chunk=chunk)
                    got = got[None]
                elif step == 0:
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


def chunked_phase(torch, runtime, serve, runs, sharing) -> dict:
    """Phase 4c: chunked admission (``CHUNKED_RUNS``) on the main path,
    each run counted alone by :func:`serve_phase`.  Checks beyond it: the
    tokens each admission forwarded (a sharer at most its tail plus one
    chunk, a cold admission its prompt padded to the chunk grid, the
    bucketed one ``max_len``); K4 launches once a layer a chunk; the f32
    streams against the same argv's one-shot run where a phase-4 / 4b run
    shares it (else their solo runs); the TConst bf16 logits through the
    bucketed admission against the CPU f32 plain path; the smollm bf16
    admissions' profile (:func:`admission_profile`).  The bf16 streams are
    not held to a one-shot run (the same bf16 product summed in chunks
    may round apart)."""
    out = {}
    for mode, layout, dtypes in CHUNKED_RUNS:
        for dtype in dtypes:
            t_phase = time.time()
            key = f"{mode}/{layout}/{dtype}"
            share = mode == "smollm"
            chunk = SHARING_CHUNK if share else BUCKET_CHUNK
            extra = ["--prefill-chunk", str(chunk)]
            if mode in TCONST_MODES:
                extra = F32_ARGS + extra
            if share and dtype == "bfloat16":
                extra += SHARING_CHUNK_BF16
            ref = sharing if share else runs
            kernels = (K4_INTRA, K4_SCAN) if mode == "mamba2" else None
            cfg, args, params, rep = serve_phase(
                torch, runtime, serve, mode, layout, dtype, kernels,
                sharing=share, extra=extra, ref_streams=ref[key]["streams"]
                if dtype == "float32" else None,
                **RUN_OVERRIDES.get((mode, dtype), {}))
            what = f"chunked {key}"
            lens = [len(p) for p in serve.session_prompts(cfg, args)]
            fwd = rep["forward_tokens"]
            grid = [-(-n // chunk) * chunk for n in lens]
            if share:
                tail = lens[0] - args.prompt_len
                for n, g, f, adopted in zip(lens, grid, fwd, rep["adopted"]):
                    check(f <= tail + chunk if adopted else f == g >= n,
                          f"{what}: forwarded {fwd} of prompts {lens} "
                          f"(adopted pages {rep['adopted']})")
                check(any(rep["adopted"]), f"{what}: no sharer")
            elif mode in TCONST_MODES:
                max_len = serve.sessions_max_len(args)
                check(fwd == [max_len] * len(lens), f"{what}: the bucketed "
                      f"admissions forwarded {fwd}, not max_len {max_len}")
            else:
                check(fwd == grid, f"{what}: forwarded {fwd}, grid {grid}")
                k4 = cfg.n_layers * sum(g // chunk for g in grid)
                check(all(rep["launches"][n]["kernel"] == k4
                          for n in (K4_INTRA, K4_SCAN)), f"{what}: K4 "
                      f"launches {rep['launches']}, expected {k4} each")
            if mode in TCONST_MODES and dtype == "bfloat16":
                rep["logit_max_err"] = summarize(logits_phase(
                    torch, serve, cfg, args, params, LOGIT_TOL[dtype],
                    n_prompts=2, chunk=chunk))
            if share and dtype == "bfloat16":
                rep["admission_profile"] = admission_profile(
                    torch, serve, cfg, args, params, chunk)
            out[key] = rep
            params = None
            torch.cuda.empty_cache()
            rep["phase_s"] = time.time() - t_phase
    return out


def admission_profile(torch, serve, cfg, args, params, chunk) -> dict:
    """smollm's admissions of its first two session prompts (one system
    prompt plus a tail each) on a two-slot paged state, the full pool:
    the one-shot admission of prompt 0, its chunked (cold) admission, and
    prompt 1's chunked admission into slot 1 with the system prompt's
    whole pages adopted from slot 0 (tail-only).  Each: tokens forwarded,
    device launches, device ms and K2's device ms of one warm call
    (torch.profiler), the wall ms (host clock to a synchronize, median of
    5 warm calls) and its logits' largest distance from the one-shot
    admission's."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import layouts as LT
    from repro_torch.models.api import build_decode
    dec = build_decode(cfg, serve.layout_spec(args, full_pool=True),
                       device="cuda")
    p = dec.prepare_params(params)
    prompts = serve.session_prompts(cfg, args)[:2]
    st = dec.init_state(2, serve.sessions_max_len(args))
    page = st.layout.page
    n = args.prompt_len // page
    pt = st.bookkeeping[LT.PAGE_TABLE]
    pt[1, :n] = pt[0, :n]
    cases = {
        "one-shot": (len(prompts[0]), lambda: dec.prefill_into_slot(
            p, st, 0, prompts[0])[0]),
        "chunked cold": (-(-len(prompts[0]) // chunk) * chunk,
                         lambda: dec.prefill_into_slot_chunked(
                             p, st, 0, prompts[0], chunk=chunk)[0]),
        "chunked sharing": (None, lambda: dec.prefill_into_slot_chunked(
            p, st, 1, prompts[1], resident_len=n * page, chunk=chunk)[0]),
    }
    ref = cases["one-shot"][1]().float()
    out = {}
    for name, (fwd, fn) in cases.items():
        logits = fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        def us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
        if fwd is None:
            start0 = min(n * page, (len(prompts[1]) - 1) // chunk * chunk)
            fwd = -(-(len(prompts[1]) - start0) // chunk) * chunk
        out[name] = {"forward_tokens": fwd,
                     "launches": sum(e.count for e in dev),
                     "device_ms": sum(us(e) for e in dev) / 1e3,
                     "k2_ms": sum(us(e) for e in dev
                                  if "flash" in e.key) / 1e3,
                     "wall_ms": float(np.median(walls)),
                     "logits_vs_one_shot": (logits.float() - ref).abs()
                     .max().item() if name != "chunked sharing" else None}
        check(bool(torch.isfinite(logits).all()), f"admission profile "
              f"{name}: non-finite logits")
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
            if name in WINDOW_CHUNK_MODELS:
                out[f"{name}/{layout}"]["chunked"] = window_chunked(
                    torch, runtime, serve, cfg, params, argv, kernels,
                    streams["cuda"])
    return out


def window_chunked(torch, runtime, serve, cfg, params, argv, kernels,
                   one_shot) -> dict:
    """A window-phase model's run on the card again with ``--prefill-chunk
    16``: every local layer's window on K2's chunk shape, an MoE model's
    routing per chunk.  Exactly the layout's kernels launch, no plain
    version; on the float layouts the streams equal the card's one-shot
    run's (int8: recorded)."""
    from repro_torch.models.api import build_model
    args = serve.parse_args(argv + ["--device", "cuda", "--prefill-chunk",
                                    str(WINDOW_CHUNK)])
    runtime.reset_counters()
    served = serve.serve_sessions(cfg, build_model(cfg, device="cuda"),
                                  params, args)
    torch.cuda.synchronize()
    counts = runtime.read_counters()
    what = f"windows chunked {cfg.name}/{args.layout}"
    for n, c in counts.items():
        check((c["kernel"] > 0) == (n in kernels) and c["plain"] == 0,
              f"{what}: launches {counts}")
    sched = served["sched"]
    grid = [-(-len(p) // WINDOW_CHUNK) * WINDOW_CHUNK
            for p in served["prompts"]]
    fwd = [s.forward_tokens for s in sched.admit_stats]
    check(fwd == grid, f"{what}: forwarded {fwd}, grid {grid}")
    same = [list(s.tokens) for s in served["sessions"]] == one_shot
    check(same or "int8" in args.layout, f"{what}: greedy streams differ "
          f"from the one-shot run's")
    return {"forward_tokens": fwd, "streams_equal_one_shot": same,
            "launches": {n: c["kernel"] for n, c in counts.items()
                         if c["kernel"]}}


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
# phase 4e: session tiering
# ---------------------------------------------------------------------------


def snapshot_bytes(sched, n_tokens: int) -> int:
    """What a spill of a session holding ``n_tokens`` (prompt + generated)
    moves to the host, from the state's shapes: the slot's row of every
    buffer without pages (bookkeeping but the page table, int8 codes and
    scales as stored) plus, of every paged field, the pages that hold
    written positions (``ceil((n_tokens + 1) / page)``)."""
    from repro_torch.models import layouts as LT
    st = sched.state
    total = sum(nbytes(t) // sched.slots for n, t in st.bookkeeping.items()
                if not n.startswith(LT.LAYOUT_BK_PREFIX))
    for f, t in st.kv.items():
        ax = sched._page_axes.get(f)
        if ax is None:
            total += nbytes(t) // sched.slots
        else:
            total += nbytes(t) // t.shape[ax] * \
                -(-(n_tokens + 1) // sched.layout.page)
    return total


def tier_run(torch, runtime, serve, argv, cfg, params, kernels=None,
             what="") -> dict:
    """One sessions run of ``argv`` on the card with weights ``params``
    (loaded once per model), counted alone: the launch counters reset
    right before the scheduler and read right after it.  With a tier
    store (``--spill-capacity-mb``): exactly ``kernels`` launch (None:
    ``layout_kernels``) and no plain version, the cycle check of the
    launcher passes, every session gets its tokens, and the spilled bytes
    are :func:`snapshot_bytes` of each spill.  Returns the streams,
    resyncs, sources and forward tokens of the admissions, and the
    tiering numbers."""
    from repro_torch.models.api import build_model
    args = serve.parse_args(argv)
    api = build_model(cfg, device="cuda")
    torch.cuda.synchronize()
    runtime.reset_counters()
    served = serve.serve_sessions(cfg, api, params, args)
    torch.cuda.synchronize()
    counts = runtime.read_counters()
    sched = served["sched"]
    rep = {"seconds": served["seconds"],
           "streams": [list(s.tokens) for s in served["sessions"]],
           "resyncs": [sched.resyncs.get(s.sid, 0)
                       for s in served["sessions"]],
           "sources": [a.source for a in sched.admit_stats],
           "forward_tokens": [a.forward_tokens for a in sched.admit_stats],
           "served": served, "api": api, "args": args}
    for s in served["sessions"]:
        check(len(s.tokens) == args.gen, f"{what}: session {s.sid}: "
              f"{len(s.tokens)} tokens, expected {args.gen}")
    if served["tiering"] is None:
        return rep
    if kernels is None:
        kernels = layout_kernels(cfg, args.layout)
    for name, c in counts.items():
        check((c["kernel"] > 0) == (name in kernels) and c["plain"] == 0,
              f"{what}: launches {counts}, expected exactly {kernels}")
    tier = served["tiering"]
    check(tier["ok"] and tier["cycles"] >= args.sessions - args.slots,
          f"{what}: {tier['cycles']} sessions completed a spill->resume "
          f"cycle, {args.sessions - args.slots} needed")
    spills = [s.tokens for s in sched.stats if s.kind == "spill"]
    per_spill = [snapshot_bytes(sched, n) for n in spills]
    check(tier["spills"] == tier["resumes"] == len(spills) > 0 and
          tier["spilled_bytes"] == sum(per_spill), f"{what}: spilled "
          f"{tier['spilled_bytes']} bytes in {tier['spills']} spills, "
          f"predicted {sum(per_spill)} ({per_spill})")
    check(all(a.forward_tokens == 0 for a in sched.admit_stats
              if a.source == "resume"), f"{what}: a resume forwarded")
    check(not tuple(sched.store.pinned_keys()), f"{what}: pins left")
    if sched._paged:
        check(sorted(sched.free_pages) == list(range(
            sched.layout.pool_pages)), f"{what}: pages leaked")
    rep.update(tiering={k: v for k, v in tier.items()},
               bytes_per_spill=sorted(set(per_spill)),
               launches={n: c["kernel"] for n, c in counts.items()
                         if c["kernel"]})
    return rep


def aten_ops(fn) -> dict:
    """The aten ops ``fn`` dispatches, by name and count (on the host,
    through a dispatch mode: independent of the device tracer)."""
    import collections
    from torch.utils._python_dispatch import TorchDispatchMode
    ops = collections.Counter()

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    with Log():
        fn()
    return dict(ops)


def readmission_profile(torch, runtime, cfg, params, n: int) -> dict:
    """The O(1) re-admission of one ``n``-token prompt: a cold admission
    into a one-slot scheduler with a tier store, then the same prompt in a
    fresh scheduler on that store.  Both after a warm-up admission of
    another prompt.  The second must restore the stored state (source
    "store", 0 tokens forwarded), launch no hand kernel and no plain
    version, trace no GEMM, give the cold admission's logits bit for bit
    and, decoding on, its stream.  The same store hit once more in a third
    scheduler dispatches no aten op of a product or an attention.  A
    restore alone dispatches data movement only (``RESTORE_OPS_RE``) and
    traces copies only, and is timed with CUDA events.  A trace that
    comes back empty is recorded so (``traced``): after the earlier
    phases' traces, the device tracer has given nothing for windows this
    short, where it traced them in a fresh process.  Each admission: the scheduler's wall ms (prefill or restore,
    to a synchronize), the device ms and launches of the whole admission
    (torch.profiler; the cold one includes the copy of its snapshot to the
    host, reported apart as ``memcpy_ms`` with the restore's upload), and
    the snapshot's bytes."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.api import build_decode
    from repro_torch.serving import scheduler as S
    from repro_torch.serving.session import Session
    from repro_torch.serving.tier_store import TierStore
    rng = np.random.RandomState(n)
    prompt = rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
    max_len = n + TIER_READMIT_GEN + 64
    store = TierStore()

    def sched(st):
        return S.SlotScheduler(build_decode(cfg, device="cuda"), params,
                               slots=1, max_len=max_len, chunk_size=8,
                               tier_store=st)

    warm = sched(TierStore())
    warm.submit(Session(prompt[::-1].copy(), max_new_tokens=1))
    warm.run()
    logits, orig = [], S.sample_tokens

    def captured(lg, *a, **kw):
        logits.append(lg[0].clone())
        return orig(lg, *a, **kw)

    def device_items(prof):
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    out, sessions = {}, []
    S.sample_tokens = captured
    try:
        for name in ("cold", "store"):
            sc = sched(store)
            sessions.append(sc.submit(Session(
                prompt.copy(), max_new_tokens=TIER_READMIT_GEN)))
            torch.cuda.synchronize()
            runtime.reset_counters()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                sc.admit_pending()
                torch.cuda.synchronize()
            counts = runtime.read_counters()
            items = device_items(prof)
            key = sc._admission_key(sessions[-1])
            out[name] = {
                "source": sc.admit_stats[0].source,
                "forward_tokens": sc.admit_stats[0].forward_tokens,
                "wall_ms": 1e3 * sc.admit_stats[0].seconds,
                "device_ms": sum(device_us(e) for e in items) / 1e3,
                # of which host <-> device copies: the cold admission's
                # snapshot put, the restore's upload
                "memcpy_ms": sum(device_us(e) for e in items
                                 if re.search("memcpy", e.key, re.I)) / 1e3,
                "launches": sum(e.count for e in items),
                "kernels": {n_: c["kernel"] for n_, c in counts.items()
                            if c["kernel"]},
                "gemms": sum(e.count for e in items
                             if re.search(GEMM_RE, e.key, re.I)),
                "snapshot_bytes": store.get(key).nbytes,
                "top_items": [(e.key[:90], e.count, device_us(e)) for e in
                              sorted(items, key=device_us)[::-1][:8]],
                "traced": bool(items)}
            if name == "store":
                check(all(c["kernel"] == 0 and c["plain"] == 0
                          for c in counts.values()), f"store hit at N {n}: "
                      f"launches {counts}")
                # copies, and the argmax (a reduction and its cast) of the
                # first token's sampling: no GEMM, no attention
                odd = [e.key for e in items
                       if not re.search(RESTORE_RE + "|reduce_kernel|"
                                        "elementwise", e.key, re.I)]
                check(out[name]["gemms"] == 0 and not odd, f"store hit at "
                      f"N {n}: device items beyond copies and the sampling's "
                      f"argmax: {odd}")
                # the same store hit once more, in a third scheduler, with
                # the aten ops it dispatches logged (host side: this holds
                # whether or not the device tracer gave anything above)
                third = sched(store)
                third.submit(Session(prompt.copy(), max_new_tokens=1))
                runtime.reset_counters()
                adm_ops = aten_ops(third.admit_pending)
                counts = runtime.read_counters()
                check(third.admit_stats[0].source == "store" and not any(
                    re.search(GEMM_OPS_RE, op) for op in adm_ops) and all(
                    c["kernel"] == 0 for c in counts.values()),
                    f"store hit at N {n}: aten ops {adm_ops}, launches "
                    f"{counts}")
                # the restore alone (idempotent: the slot holds this
                # state): its aten ops, CUDA-event and host times (medians
                # of 5) and its device trace
                blob = store.get(key)
                ops = aten_ops(lambda: sc._restore(0, blob))
                check(all(re.search(RESTORE_OPS_RE, op) for op in ops),
                      f"restore at N {n}: aten ops {ops}")
                walls, events = [], []
                for _ in range(5):
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ev[0].record()
                    sc._restore(0, blob)
                    ev[1].record()
                    torch.cuda.synchronize()
                    walls.append(1e3 * (time.perf_counter() - t0))
                    events.append(ev[0].elapsed_time(ev[1]))
                names = []
                for _ in range(3):    # a short window may trace nothing
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        sc._restore(0, blob)
                        torch.cuda.synchronize()
                    names = sorted({e.key for e in device_items(prof)})
                    if names:
                        break
                    time.sleep(1.0)
                check(all(re.search(RESTORE_RE, k, re.I) for k in names),
                      f"restore at N {n}: device items {names}")
                out[name].update(
                    admission_ops=adm_ops, restore_ops=ops,
                    restore_items=names,
                    restore_wall_ms=statistics.median(walls),
                    restore_event_ms=statistics.median(events))
            sc.run()
    finally:
        S.sample_tokens = orig
    cold, hit = out["cold"], out["store"]
    check(cold["source"] == "cold" and hit["source"] == "store" and
          hit["forward_tokens"] == 0, f"re-admission at N {n}: {out}")
    # the scheduler samples its first token from these logits (the decode
    # chunks sample through the decode protocol's own reference)
    check(len(logits) == 3 and all(torch.equal(logits[0], lg)
                                   for lg in logits[1:]),
          f"re-admission at N {n}: the store hits' logits differ from the "
          f"cold admission's")
    out["streams_equal"] = sessions[0].tokens == sessions[1].tokens
    check(cfg.dtype != "float32" or out["streams_equal"], f"re-admission "
          f"at N {n}: the f32 streams differ")
    return out


def tiering_phase(torch, runtime, serve, runs, sharing, weights) -> dict:
    """Phase 4e: session tiering on the main path (runs 1-5 of the
    comment above ``TIER_ARGS``), each run counted alone.  Checks beyond
    :func:`tier_run`'s: run 1, each session's resyncs equal the untiered
    f32 run's (a session's resync count is a function of its prompt and
    gen: the host mirror restored with the slot keeps it), the f32 streams
    equal the untiered run's, whose first four equal phase 4's run of the
    same argv (held to their solo runs there) and the last two their solo
    runs; run 2, the f32 streams equal the same argv's untiered run; run
    3, every cold admission but the first re-adopts the retired system-
    prompt pages and forwards one chunk, resumes forward 0, and the f32
    streams equal 4b's one-shot untiered run of the argv (held to their
    solo runs there); run 4, :func:`readmission_profile`; run 5, demotions
    and promotions, streams equal run 1's f32 ones.  ``weights``: the
    seeded weights of tconst-41m and smollm-360m by arch, which phase 4f
    serves again."""
    import shutil
    from repro_torch.config import get_config
    out = {}
    # tconst-41m's weights: every mode and dtype below
    tconst_params = weights["tconst-41m"]

    def tconst_cfg(mode, dtype):
        return get_config("tconst-41m").replace(attention_mode=mode,
                                                dtype=dtype)

    # run 1: tconst / dense
    base = SESSIONS_ARGS + ["--arch", "tconst-41m", "--layout", "dense"]
    untiered = tier_run(torch, runtime, serve, base + ["--dtype", "float32"]
                        + TIER_DENSE_ARGS[:-2], tconst_cfg("tconst",
                                                           "float32"),
                        tconst_params, what="tconst/dense f32 untiered")
    for dtype in ("bfloat16", "float32"):
        key = f"tconst/dense/{dtype}"
        t0 = time.time()
        rep = tier_run(torch, runtime, serve, base + ["--dtype", dtype] +
                       TIER_DENSE_ARGS, tconst_cfg("tconst", dtype),
                       tconst_params, what=f"tiering {key}")
        check(rep["resyncs"] == untiered["resyncs"] and
              min(rep["resyncs"]) >= 1, f"tiering {key}: resyncs "
              f"{rep['resyncs']}, untiered {untiered['resyncs']}")
        if dtype == "float32":
            check(rep["streams"] == untiered["streams"], f"tiering {key}: "
                  f"f32 streams differ from the untiered run's")
            check(untiered["streams"][:4] ==
                  runs["tconst/dense/float32"]["streams"], "the untiered "
                  "f32 run's first streams differ from phase 4's")
            served = untiered["served"]
            solo = serve.check_sessions(
                untiered["api"], tconst_params,
                {**served, "tiering": None, "sessions":
                 served["sessions"][4:], "prompts": served["prompts"][4:]},
                untiered["args"])
            check(solo["rc"] == 0, f"tiering {key}: f32 streams differ "
                  f"from their solo runs")
        rep["phase_s"] = time.time() - t0
        out[key] = rep
    # run 5: run 1's f32 argv on a 1 MiB RAM tier over a disk tier
    t0 = time.time()
    shutil.rmtree(OUT / "tier_spill", ignore_errors=True)
    try:
        rep = tier_run(torch, runtime, serve, base + ["--dtype", "float32"]
                       + TIER_DENSE_ARGS + TIER_DISK_ARGS,
                       tconst_cfg("tconst", "float32"), tconst_params,
                       what="tiering tconst/dense f32 disk tier")
        store = rep["tiering"]["store"]
        check(store["demotions"] > 0 and store["promotions"] > 0 and
              rep["streams"] == out["tconst/dense/float32"]["streams"],
              f"disk tier: {store}, streams equal run 1's: "
              f"{rep['streams'] == out['tconst/dense/float32']['streams']}")
        rep["files"] = sum(1 for _ in (OUT / "tier_spill").rglob("*.npy"))
    finally:
        shutil.rmtree(OUT / "tier_spill", ignore_errors=True)
    rep["phase_s"] = time.time() - t0
    out["tconst/dense/float32 disk"] = rep
    # run 2: TLinFormer / paged_int8 with prefix sharing
    t0 = time.time()
    argv = {d: sharing_argv("tlin", "paged_int8", d) + TIER_PAGED_ARGS
            for d in ("bfloat16", "float32")}
    ref = tier_run(torch, runtime, serve, argv["float32"][:-2],
                   tconst_cfg("tlin", "float32"), tconst_params,
                   what="tlin/paged_int8 f32 untiered")
    for dtype in ("bfloat16", "float32"):
        key = f"tlin/paged_int8/{dtype}"
        rep = tier_run(torch, runtime, serve, argv[dtype],
                       tconst_cfg("tlin", dtype), tconst_params,
                       what=f"tiering {key}")
        check(dtype != "float32" or rep["streams"] == ref["streams"],
              f"tiering {key}: f32 streams differ from the untiered run's")
        out[key] = rep
    out["tlin/paged_int8/bfloat16"]["phase_s"] = time.time() - t0
    # run 4: the O(1) re-admission
    t0 = time.time()
    out["readmission"] = {
        f"{dtype} N {n}": readmission_profile(
            torch, runtime, tconst_cfg("tconst", dtype), tconst_params, n)
        for dtype, ns in (("bfloat16", TIER_READMIT_N),
                          ("float32", TIER_READMIT_N[:1])) for n in ns}
    out["readmission"]["phase_s"] = time.time() - t0
    # run 3: smollm / paged, one slot: retired prefix pages re-adopted
    t0 = time.time()
    full = weights[SMOLLM]
    for dtype in ("float32", "bfloat16"):
        key = f"smollm/paged/{dtype}"
        cfg = get_config(SMOLLM).replace(dtype=dtype)
        params = full
        argv = sharing_argv("smollm", "paged", dtype) + TIER_SMOLLM_ARGS
        if dtype == "float32":
            cfg = cfg.replace(n_layers=SMOLLM_F32_DEPTH)
            params = {**full, "layers": full["layers"][:SMOLLM_F32_DEPTH]}
        else:
            argv = argv + TIER_SMOLLM_BF16
        rep = tier_run(torch, runtime, serve, argv, cfg, params,
                       what=f"tiering {key}")
        args = rep["args"]
        resident = args.prompt_len // args.page_size
        cold = [f for s, f in zip(rep["sources"], rep["forward_tokens"])
                if s == "cold"]
        check(cold[1:] == [SHARING_CHUNK] * (len(cold) - 1) and
              rep["tiering"]["pages_readopted"] == resident *
              (len(cold) - 1) and rep["tiering"]["pages_retired"] > 0,
              f"tiering {key}: cold admissions forwarded {cold}, "
              f"{rep['tiering']['pages_readopted']} pages re-adopted "
              f"({resident} a re-adoption)")
        check(dtype != "float32" or rep["streams"] ==
              sharing[key]["streams"][:args.sessions], f"tiering {key}: "
              f"f32 streams differ from 4b's untiered one-shot run")
        out[key] = rep
    out["smollm/paged/float32"]["phase_s"] = time.time() - t0
    torch.cuda.empty_cache()
    for rep in out.values():
        for k in ("api", "args", "served"):
            rep.pop(k, None)
    return out


# ---------------------------------------------------------------------------
# phase 4f: workload traces, telemetry and the scheduling policies
# ---------------------------------------------------------------------------


def chunk_units(rep: dict) -> dict:
    """The numbers of a workload run that are a function of the trace and
    the schedule alone: the telemetry summary in chunk units, the
    scheduler's final clock, each admission's source and forward tokens,
    the policy's deferral answers and the sessions that crossed a
    resync."""
    summ = rep["summary"]
    keep = ("sessions", "finished", "tokens_out", "ttft_chunks",
            "itl_chunks", "queue_wait_chunks", "slo", "spills", "resumes",
            "ttft_compile_excluded")
    return {**{k: summ[k] for k in keep},
            **{k: rep[k] for k in ("clock", "sources", "forward_tokens",
                                   "deferrals", "crossed_resync")}}


def workload_run(torch, runtime, serve, cfg, params, name: str, policy: str,
                 device: str = "cuda") -> dict:
    """Replay ``WORKLOAD_RUNS[name]``'s trace on ``device`` under
    ``policy`` through ``serve.drive`` (the launcher's replay), the launch
    counters reset right before it and read right after.  Records the
    telemetry summary, the admissions, the policy's deferral answers and
    the ``spill_cost`` of every victim candidate it weighed.  The trace
    is drawn with ``cfg.vocab_size``: a reduced model must keep the full
    vocabulary for the trace to be the same."""
    from repro_torch.models.api import build_decode
    from repro_torch.models.layouts import LayoutSpec
    from repro_torch.serving.metrics import ServingTelemetry
    from repro_torch.serving.scheduler import SlotScheduler
    from repro_torch.serving.tier_store import TierStore
    from repro_torch.serving.workload import WorkloadSpec, generate_workload
    run = WORKLOAD_RUNS[name]
    spec = WorkloadSpec(vocab=cfg.vocab_size, **run["spec"])
    longest = max(hi for _, _, hi in spec.output_mix)
    arrivals = generate_workload(
        spec, run["seed"], max_prompt_len=run["max_len"] - longest -
        run["chunk"])
    layout = None if run["layout"] == "dense" else LayoutSpec(
        kind=run["layout"], page_size=run["page"], pool_pages=run["pool"])
    tel = ServingTelemetry()
    sched = SlotScheduler(
        build_decode(cfg, layout, device=device,
                     prefill_chunk=run.get("prefill_chunk")),
        params, slots=run["slots"], max_len=run["max_len"],
        chunk_size=run["chunk"], prefix_sharing=run.get("prefix_sharing",
                                                        False),
        tier_store=TierStore(capacity_bytes=WORKLOAD_STORE_BYTES),
        preempt_chunks=1, policy=policy, telemetry=tel)
    deferrals, costs = [], []
    defer, cost = sched.policy.defer_admission, sched.spill_cost

    def counted_defer(sch, session, plan):
        deferrals.append(defer(sch, session, plan))
        return deferrals[-1]

    def recorded_cost(slot):
        costs.append(cost(slot))
        return costs[-1]

    sched.policy.defer_admission, sched.spill_cost = counted_defer, \
        recorded_cost
    if device == "cuda":
        torch.cuda.synchronize()
    runtime.reset_counters()
    seconds = serve.drive(sched, arrivals)
    counts = runtime.read_counters()
    sessions = [a.session for a in arrivals]
    rep = {"seconds": seconds, "summary": tel.summary(),
           "clock": sched.clock,
           "sources": [a.source for a in sched.admit_stats],
           "forward_tokens": [a.forward_tokens for a in sched.admit_stats],
           "deferrals": [sum(deferrals), len(deferrals)],
           "crossed_resync": sum(sched.resyncs.get(s.sid, 0) >= 1
                                 for s in sessions),
           "spill_cost_bytes": sorted({c["bytes"] for c in costs}),
           "spill_cost_readmit": sorted({c["readmit"] for c in costs}),
           "spill_stats": dict(sched.spill_stats),
           "page_waits": sched.page_waits,
           "launches": {n: c["kernel"] for n, c in counts.items()
                        if c["kernel"]},
           "plain": {n: c["plain"] for n, c in counts.items()
                     if c["plain"]},
           "streams": [list(s.tokens) for s in sessions],
           "per_session": [(s.spills, s.resumes) for s in sessions],
           "drained": all(len(s.tokens) == s.max_new_tokens and s.done
                          for s in sessions),
           "pins_left": len(tuple(sched.store.pinned_keys())),
           "pages_free": sorted(sched.free_pages) ==
           list(range(sched.layout.pool_pages)) and
           not sched.page_refcounts().any() if sched._paged else None}
    return rep


def check_workload_run(rep: dict, kernels, what: str) -> None:
    """A workload run launched exactly ``kernels`` and no plain version,
    drained every session, resumed every spill of each session, and left
    no pin and (paged) every page free."""
    check(set(rep["launches"]) == set(kernels) and not rep["plain"],
          f"{what}: launches {rep['launches']}, plain {rep['plain']}; "
          f"expected exactly {kernels}")
    check(rep["drained"] and rep["summary"]["finished"] ==
          rep["summary"]["sessions"], f"{what}: not every session drained")
    check(all(a == b for a, b in rep["per_session"]) and
          rep["summary"]["spills"] == rep["summary"]["resumes"],
          f"{what}: spills and resumes differ {rep['per_session']}")
    check(rep["pins_left"] == 0, f"{what}: {rep['pins_left']} pins left")
    check(rep["pages_free"] in (None, True), f"{what}: pages leaked")


def workload_phase(torch, runtime, serve, weights) -> dict:
    """Phase 4f: (a) the launcher's ``--workload`` mode through ``main``
    at full width; (b) and (c) the runs of ``WORKLOAD_RUNS`` on the
    weights phase 4e served (``weights``, by arch) under both policies,
    each counted alone and held by :func:`check_workload_run`;
    the f32 streams equal across the policies at every trace position,
    and every f32 run's chunk-unit numbers equal ``WORKLOAD_PREDICTION``
    (the bf16 runs' are recorded beside them)."""
    import io
    from repro_torch.config import get_config
    out = {}
    # (a) the normal entry point, full width
    t0 = time.time()
    buf = io.StringIO()
    torch.cuda.synchronize()
    runtime.reset_counters()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(WORKLOAD_CLI_ARGS)
    torch.cuda.synchronize()
    counts = runtime.read_counters()
    text = buf.getvalue()
    print(text, end="")
    lines = text.splitlines()
    summary = json.loads("\n".join(lines[lines.index("{"):
                                         lines.index("}") + 1]))
    launched = {n: c["kernel"] for n, c in counts.items() if c["kernel"]}
    check(rc == 0 and "workload drained: ok" in text and
          summary["finished"] == summary["sessions"] == 8,
          f"serve --workload: rc {rc}, summary {summary}")
    check(set(launched) == {K1, K2} and not any(
        c["plain"] for c in counts.values()), f"serve --workload: "
          f"launches {counts}, expected exactly K1 and K2")
    out["cli"] = {"rc": rc, "summary": summary, "launches": launched,
                  "phase_s": time.time() - t0}
    # (b) and (c)
    for name, run in WORKLOAD_RUNS.items():
        arch, over = MODELS[run["mode"]]
        full = weights[arch]
        for dtype in run["dtypes"]:
            cfg = get_config(arch).replace(dtype=dtype, **over)
            params = full
            if run["mode"] == "smollm":
                cfg = cfg.replace(n_layers=SMOLLM_F32_DEPTH)
                params = {**full, "layers": full["layers"][:SMOLLM_F32_DEPTH]}
            kernels = layout_kernels(cfg, run["layout"])
            for policy in WORKLOAD_POLICIES:
                key = f"{name}/{dtype}/{policy}"
                t0 = time.time()
                rep = workload_run(torch, runtime, serve, cfg, params, name,
                                   policy)
                check_workload_run(rep, kernels, f"workload {key}")
                rep["chunk_units"] = chunk_units(rep)
                pred = WORKLOAD_PREDICTION.get(f"{name}/{policy}")
                rep["as_predicted"] = rep["chunk_units"] == pred
                check(dtype != "float32" or rep["as_predicted"],
                      f"workload {key}: chunk-unit numbers "
                      f"{rep['chunk_units']} differ from the prediction "
                      f"{pred}")
                rep["phase_s"] = time.time() - t0
                out[key] = rep
            a, b = (out[f"{name}/{dtype}/{p}"]["streams"]
                    for p in WORKLOAD_POLICIES)
            out[f"{name}/{dtype}/fifo"]["streams_equal_across_policies"] = \
                out[f"{name}/{dtype}/slo"]["streams_equal_across_policies"] = \
                a == b
            check(dtype != "float32" or a == b, f"workload {name} f32: the "
                  f"streams differ between the policies")
        torch.cuda.empty_cache()
    slo = out["smollm/paged/float32/slo"]
    check(slo["deferrals"][1] > 0, "workload smollm/paged slo: "
          "defer_admission was never consulted")
    check(min(slo["spill_cost_readmit"]) > 0 and
          len(slo["spill_cost_bytes"]) > 1, f"workload smollm/paged slo: "
          f"spill costs {slo['spill_cost_bytes']}, readmit "
          f"{slo['spill_cost_readmit']}")
    dense = out["tconst/dense/float32/slo"]
    check(2 * dense["crossed_resync"] > dense["summary"]["sessions"],
          f"workload tconst/dense: {dense['crossed_resync']} sessions "
          f"crossed a resync")
    for rep in out.values():
        rep.pop("streams", None)
    return out


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
        t0 = time.time()
        cfg, api, params = T.load(args)
        load_s = time.time() - t0
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
                            if c["kernel"]}, "load_s": load_s}
        runs = out["runs"].setdefault(mode, [])
        if not runs:
            step_fn = make_train_step(api, AdamWConfig(lr=args.lr),
                                      warmup_cosine(0, args.steps))
            batch = {"tokens": torch.from_numpy(np.ascontiguousarray(
                data[0]["tokens"][:, :args.seq])).cuda()}
            t0 = time.time()
            rec["profile"] = step_profile(torch, runtime, step_fn,
                                          res["params"], res["opt"], batch)
            rec["profile_s"] = time.time() - t0
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
    max_len = KERNEL_MAX_LEN

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
            t_logits = time.time()
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
            rep["parts_s"]["logits"] = time.time() - t_logits
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
                  f"{tol}); {time.time() - t_phase:.1f}s (serve "
                  f"{rep['seconds']:.1f}, " + ", ".join(
                      f"{k} {v:.1f}" for k, v in rep["parts_s"].items())
                  + ")")
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

    # 4b. prefix sharing and copy-on-write pages on the paged layouts
    sharing = {}
    for mode, layout in SHARING_RUNS:
        for dtype in ("bfloat16", "float32"):
            t_phase = time.time()
            rep = serve_phase(torch, runtime, serve, mode, layout, dtype,
                              None, sharing=True,
                              **RUN_OVERRIDES.get((mode, dtype), {}))[3]
            key = f"{mode}/{layout}/{dtype}"
            sharing[key] = rep
            torch.cuda.empty_cache()
            phase_s[f"sharing {key}"] = time.time() - t_phase
            share = rep["sharing"]
            launched = {n: c["kernel"] for n, c in rep["launches"].items()
                        if c["kernel"]}
            print(f"[sharing] {key}: {share['shared']} shared pages after "
                  f"the first admissions ({share['assigned']} assigned); "
                  f"assigned KV bytes {share['assigned_kv_bytes']} (without "
                  f"sharing {share['unshared_kv_bytes']}); "
                  f"{rep['pages_forked']} pages forked, "
                  f"{rep['fork_pauses']} fork pauses, {rep['page_waits']} "
                  f"page waits; chunks watched {rep['cow_watch']}; launches "
                  f"{launched} (plain 0); {phase_s[f'sharing {key}']:.1f}s")

    # 4c. chunked, KV-conditioned admission: tail-only under sharing,
    # bucketed for the TConst core, K4 from a carried state
    t_phase = time.time()
    chunked = chunked_phase(torch, runtime, serve, runs, sharing)
    phase_s["chunked"] = time.time() - t_phase
    for key, rep in chunked.items():
        launched = {n: c["kernel"] for n, c in rep["launches"].items()
                    if c["kernel"]}
        print(f"[chunked] {key}: forward tokens per admission "
              f"{rep['forward_tokens']} (adopted pages "
              f"{rep.get('adopted', '-')}); launches {launched} (plain 0); "
              f"streams equal the one-shot run's: "
              f"{rep.get('streams_equal_ref', 'not held (bf16)')}; "
              f"logits {rep.get('logit_max_err', 'not checked')}; "
              f"{rep['phase_s']:.1f}s")
        if "admission_profile" in rep:
            for name, a in rep["admission_profile"].items():
                print(f"[chunked] {key} admission {name}: forward "
                      f"{a['forward_tokens']} tokens, {a['launches']} device "
                      f"launches, {a['device_ms']:.3f} device ms (K2 "
                      f"{a['k2_ms']:.3f}), wall "
                      f"{a['wall_ms']:.2f} ms; logits vs one-shot "
                      f"{a['logits_vs_one_shot']}")
    print(f"[chunked] {phase_s['chunked']:.1f}s")

    # 4d. sliding windows through the models: K1 lo > 0, K3 window > 0
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
        if "chunked" in v:
            c = v["chunked"]
            print(f"[windows] {k} --prefill-chunk {WINDOW_CHUNK}: forward "
                  f"{c['forward_tokens']}, launches {c['launches']}, streams "
                  f"equal the one-shot run's: {c['streams_equal_one_shot']}")
    print(f"[windows] {phase_s['windows']:.1f}s")

    # 4e. session tiering: spill / resume, retired prefix pages re-adopted,
    # the O(1) TConst re-admission, the disk tier
    t_phase = time.time()
    # the seeded weights 4e and 4f both serve, drawn once
    weights = {arch: serve.load(serve.parse_args(["--arch", arch]))[2]
               for arch in ("tconst-41m", SMOLLM)}
    tiering = tiering_phase(torch, runtime, serve, runs, sharing, weights)
    phase_s["tiering"] = time.time() - t_phase
    for key, rep in tiering.items():
        if key == "readmission":
            continue
        t = rep["tiering"]
        print(f"[tiering] {key}: {t['spills']} spills / {t['resumes']} "
              f"resumes, {t['spilled_bytes']} bytes (a spill "
              f"{rep['bytes_per_spill']}), {t['cycles']} sessions cycled; "
              f"admission cache {t['admit_store_hits']} hits / "
              f"{t['admit_store_puts']} puts; pages retired "
              f"{t['pages_retired']} / re-adopted {t['pages_readopted']}; "
              f"store {t['store']}; forward tokens {rep['forward_tokens']} "
              f"({rep['sources']}); resyncs {rep['resyncs']}; launches "
              f"{rep['launches']} (plain 0)")
    for key, r in tiering["readmission"].items():
        if key == "phase_s":
            continue
        print(f"[tiering] re-admission tconst-41m {key}: " + "; ".join(
            f"{name}: forward {a['forward_tokens']}, {a['wall_ms']:.3f} "
            f"wall ms, {a['device_ms']:.3f} device ms (memcpy "
            f"{a['memcpy_ms']:.3f}), {a['launches']} "
            f"launches (traced: {a['traced']}), kernels {a['kernels']}, "
            f"GEMMs {a['gemms']}, "
            f"snapshot {a['snapshot_bytes']} B"
            for name, a in r.items() if isinstance(a, dict)) +
            f"; the restore alone {r['store']['restore_wall_ms']:.3f} wall "
            f"ms, {r['store']['restore_event_ms']:.3f} device ms (CUDA "
            f"events), aten ops {r['store']['restore_ops']}, device items "
            f"{r['store']['restore_items']}; streams equal "
            f"{r['streams_equal']}")
    print(f"[tiering] {phase_s['tiering']:.1f}s")

    # 4f. workload traces under both scheduling policies, telemetry
    t_phase = time.time()
    workloads = workload_phase(torch, runtime, serve, weights)
    weights = None
    torch.cuda.empty_cache()
    phase_s["workload"] = time.time() - t_phase
    for key, rep in workloads.items():
        summ = rep["summary"]
        if key == "cli":
            print(f"[workload] serve --workload bursty --policy slo (full "
                  f"width): finished {summ['finished']}/{summ['sessions']},"
                  f" TTFT chunks {summ['ttft_chunks']}, warm TTFT s "
                  f"{summ['ttft_seconds_warm']}, launches {rep['launches']}"
                  f" (plain 0); {card}")
            continue
        print(f"[workload] {key}: {json.dumps(rep['chunk_units'])}; as "
              f"predicted: {rep['as_predicted']}; warm TTFT s "
              f"{summ['ttft_seconds_warm']}; streams equal across policies:"
              f" {rep['streams_equal_across_policies']}; spill costs "
              f"{rep['spill_cost_bytes'][:1]}..{rep['spill_cost_bytes'][-1:]}"
              f" B, readmit {rep['spill_cost_readmit'][:1]}..; "
              f"{rep['spill_stats']}; launches {rep['launches']} (plain 0); "
              f"{rep['seconds']:.1f}s; {card}")
    for name, run in WORKLOAD_RUNS.items():
        for dtype in run["dtypes"]:
            att = {p: workloads[f"{name}/{dtype}/{p}"]["summary"]["slo"][
                "attainment"] for p in WORKLOAD_POLICIES}
            print(f"[workload] {name} {dtype}: SLO attainment slo "
                  f"{att['slo']} vs fifo {att['fifo']} (recorded, not gated)")
    print(f"[workload] {phase_s['workload']:.1f}s")

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
    # K2 at a chunked admission's shape (phase 3's chunk rows; launches of
    # the smollm bf16 run of phase 4c)
    name, (_, src, repl, _) = K2, KERNELS[K2]
    chunk_rows_ = [x for x in rows if "_chunk_" in x["case"]]
    r = next(x for x in chunk_rows_ if x["case"] == "smollm_chunk_960"
             and x["dtype"] == "bfloat16")
    line.append({
        "name": name, "case": "prefill_chunk", "route": "cuda",
        "source": src, "replaces": repl,
        "launches": chunked["smollm/paged/bfloat16"]["launches"][K2][
            "kernel"],
        "max_abs_err": max(x["max_abs_err"] for x in chunk_rows_),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    detail = {
        "card": card, "kind": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": built,
        "kernel_rows": rows, "sass_tensor_core_ops": sass,
        "launches_per_call": per_call, "sessions": runs,
        "sharing": sharing, "chunked": chunked, "windows": windows,
        "tiering": tiering, "workload": workloads,
        "engines": engines,
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
