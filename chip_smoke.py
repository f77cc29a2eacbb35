#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure raises, so the exit code is non-zero):

1. Device: a CUDA device must be visible; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles every kernel of the main path from
   ``src/repro_torch/csrc/*.cu`` with ``nvcc`` for ``sm_90a`` (one process
   per source, in parallel) and times it.
3. Kernels: each kernel against its plain PyTorch version on the same
   CUDA tensors, in bf16 and f32, at the shapes ``tconst-41m`` serving
   gives it (K1: the decode step's self and cross attention with full,
   partial and empty slot ranges; K2: the resync's compress / context
   self / restore and the admission's window passes, with dead keys and
   negative query positions).  Prints the kernel's, the plain version's
   and ``F.scaled_dot_product_attention``'s times (a yardstick only; the
   port never calls it) and the least time the card could take.
4. Serve ``tconst-41m`` at full width with the port's seeded init:
   ``--sessions 4 --slots 2 --prompt-len 600 --gen 320 --chunk 32`` in
   bf16 (the main path: launch counters reset before the scheduler runs
   and read right after it, before the solo runs that check the streams)
   and in f32 (greedy streams must equal the solo runs).  Each session's
   first-token logits and those of a few decode steps after it are held
   against the f32 plain path on the CPU.
5. Uniform-batch Engine (``--batch 4 --prompt-len 1024 --gen 800``): the
   mean cache-hit step and resync times (three warm resyncs).
6. Prints the per-kernel JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.  Details go to
   ``build/chip_smoke.json``.

Numbers are device times from CUDA events (warm medians); a time is only
meaningful next to the card name and power limit printed with it.
"""
from __future__ import annotations

import json
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
# logits of the card path against the CPU f32 plain path: bf16 is about 3x
# the worst error seen (0.024 with logits of std ~0.42); f32 is far above
# its error (3e-6) yet far below any wrong attention
LOGIT_TOL = {"float32": 2e-3, "bfloat16": 0.075}
LOGIT_STEPS = 8      # decode steps checked after the prefill (K1's path)

SESSIONS_ARGS = ["--arch", "tconst-41m", "--sessions", "4", "--slots", "2",
                 "--prompt-len", "600", "--gen", "320", "--chunk", "32"]
# gen 800 from a 1024-token prompt: four resyncs, three of them warm
ENGINE_ARGS = ["--arch", "tconst-41m", "--batch", "4", "--prompt-len",
               "1024", "--gen", "800"]


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


def k1_cases(torch, cfg, dev):
    """(label, B, S, lo, hi) at the decode step's shapes: B = slots."""
    W = cfg.tconst.w_og
    t = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa
    return [
        ("self_full", 2, W, t([0, 0]), t([W, W])),
        ("self_partial", 2, W, t([0, 0]), t([89, 170])),
        ("cross_partial", 2, cfg.tconst.w_oh, t([156, 0]),
         t([cfg.tconst.w_oh, cfg.tconst.w_oh])),
        ("empty", 2, W, t([0, W]), t([0, W])),
    ]


def k2_cases(torch, cfg, dev, max_len: int):
    """(label, q_pos, k_pos, causal) at the resync / admission shapes."""
    from repro_torch.kernels.flash_attention import INVALID_POS
    W = cfg.tconst.w_oh
    hist_len = torch.tensor([512, 100], dtype=torch.int32, device=dev)
    pos = torch.arange(max_len, dtype=torch.int32, device=dev)[None]
    pos = pos.expand(2, max_len)
    hist_kp = torch.where(pos < hist_len[:, None], pos,
                          torch.full_like(pos, INVALID_POS))
    tail = hist_len[:, None] - W + torch.arange(W, dtype=torch.int32,
                                                device=dev)[None]
    tail_kp = torch.where(tail >= 0, tail, torch.full_like(tail, INVALID_POS))
    g0 = 88
    gen = 512 + torch.arange(g0, dtype=torch.int32, device=dev)[None]
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
    ]


def sdpa_k1(torch, q, k, v, lo, hi):
    import torch.nn.functional as F
    S = k.shape[1]
    slot = torch.arange(S, device=q.device)[None]
    mask = ((slot >= lo[:, None]) & (slot < hi[:, None]))[:, None, None]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def sdpa_k2(torch, q, k, v, mask):
    import torch.nn.functional as F
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    m = mask[:, None]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=m, enable_gqa=True)


def kernel_phase(torch, cfg, dev, max_len: int):
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for label, B, S, lo, hi in k1_cases(torch, cfg, dev):
            q = randn((B, H, D), dt)
            k = randn((B, S, KV, D), dt)
            v = randn((B, S, KV, D), dt)
            out = DA.decode_attention_cuda(q, k, v, lo, hi)
            ref = DA.decode_attention_plain(q, k, v, lo, hi)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            check(bool(torch.isfinite(out.float()).all()),
                  f"K1 {label}/{dname}: non-finite output")
            check(err <= TOL[dname], f"K1 {label}/{dname}: max |kernel - "
                  f"plain| = {err} > {TOL[dname]}")
            n = (hi - lo).clamp(min=0)
            used = int(n.sum()) * KV * D * k.element_size()
            b, by = bound_ms(nbytes(q, lo, hi, out) + 2 * used,
                             4 * H * D * int(n.sum()), dname)
            rows.append({
                "kernel": "decode_attention", "case": label, "dtype": dname,
                "shape": f"B={B} H={H} KV={KV} D={D} S={S}",
                "max_abs_err": err, "tol": TOL[dname],
                "ms": time_ms(lambda: DA.decode_attention_cuda(
                    q, k, v, lo, hi)),
                "plain_ms": time_ms(lambda: DA.decode_attention_plain(
                    q, k, v, lo, hi)),
                "library_ms": time_ms(sdpa_k1(torch, q, k, v, lo, hi)),
                "bound_ms": b, "bound_by": by})
        for label, qp, kp, causal in k2_cases(torch, cfg, dev, max_len):
            B, Lq, Lk = qp.shape[0], qp.shape[1], kp.shape[1]
            if kp.shape[0] != B:
                kp = kp.expand(B, Lk).contiguous()
            q = randn((B, Lq, H, D), dt)
            k = randn((B, Lk, KV, D), dt)
            v = randn((B, Lk, KV, D), dt)
            out = FA.flash_attention_cuda(q, k, v, qp, kp, causal)
            ref = FA.flash_attention_plain(q, k, v, qp, kp, causal)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            check(bool(torch.isfinite(out.float()).all()),
                  f"K2 {label}/{dname}: non-finite output")
            check(err <= TOL[dname], f"K2 {label}/{dname}: max |kernel - "
                  f"plain| = {err} > {TOL[dname]}")
            mask = FA.position_mask(qp, kp, causal, 0)
            pairs = int(mask.sum())
            # K/V bytes only of the keys some query attends (dead keys and
            # keys past every query's position need not be read)
            keys = int(mask.any(dim=1).sum())
            used = keys * KV * D * k.element_size()
            b, by = bound_ms(nbytes(q, qp, kp, out) + 2 * used,
                             4 * H * D * pairs, dname)
            rows.append({
                "kernel": "flash_attention", "case": label, "dtype": dname,
                "shape": f"B={B} Lq={Lq} Lk={Lk} H={H} KV={KV} D={D}",
                "max_abs_err": err, "tol": TOL[dname],
                "ms": time_ms(lambda: FA.flash_attention_cuda(
                    q, k, v, qp, kp, causal)),
                "plain_ms": time_ms(lambda: FA.flash_attention_plain(
                    q, k, v, qp, kp, causal)),
                "library_ms": time_ms(sdpa_k2(torch, q, k, v, mask)),
                "bound_ms": b, "bound_by": by})
    for r in rows:
        print(f"[kernel] {r['kernel']:16s} {r['case']:13s} {r['dtype']:8s} "
              f"{r['shape']:34s} err={r['max_abs_err']:.2e} "
              f"ms={r['ms']:.4f} plain={r['plain_ms']:.4f} "
              f"sdpa={r['library_ms']:.4f} bound={r['bound_ms']:.5f} "
              f"({r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the port's main path
# ---------------------------------------------------------------------------


def serve_phase(torch, runtime, serve, dtype: str):
    args = serve.parse_args(SESSIONS_ARGS + ["--dtype", dtype])
    cfg, api, params = serve.load(args)
    torch.cuda.synchronize()
    runtime.reset_counters()
    served = serve.serve_sessions(cfg, api, params, args)
    torch.cuda.synchronize()
    counts = runtime.read_counters()
    # the solo runs the streams are checked against come after the read
    rep = serve.check_sessions(api, params, served, args)
    for name, c in counts.items():
        check(c["kernel"] > 0, f"{dtype} sessions: kernel {name} was never "
              f"launched ({counts})")
        check(c["plain"] == 0, f"{dtype} sessions: plain version of {name} "
              f"ran on the main path ({counts})")
    for s in rep["sessions"]:
        check(len(s["tokens"]) == args.gen, f"session {s['sid']}: "
              f"{len(s['tokens'])} tokens, expected {args.gen}")
        check(s["resyncs"] >= 1, f"session {s['sid']} crossed no resync")
    if dtype == "float32":
        check(rep["rc"] == 0 and all(s["matches"] for s in rep["sessions"]),
              "f32 greedy session streams differ from their solo runs")
    return cfg, args, params, rep, counts


def logits_phase(torch, serve, cfg, args, params, device="cuda"):
    """Logits of each session prompt on the card (kernels) against the
    plain path on the CPU in f32, same weights: the first token (the
    admission, K2) and ``LOGIT_STEPS`` cache-hit steps after it (K1), both
    fed the reference's greedy tokens."""
    from repro_torch.models.api import build_model
    prompts = serve.session_prompts(cfg, args)
    max_len = serve.sessions_max_len(args)
    ref_cfg = cfg.replace(dtype="float32")
    ref_dec = build_model(ref_cfg, device="cpu").decode
    ref_params = ref_dec.prepare_params(params)
    card_dec = build_model(cfg, device=device).decode
    card_params = card_dec.prepare_params(params)
    errs = []
    for p in prompts:
        got, card_st = card_dec.prefill(card_params, {"tokens": p[None]},
                                        max_len)
        ref, ref_st = ref_dec.prefill(ref_params, {"tokens": p[None]},
                                      max_len)
        for step in range(LOGIT_STEPS + 1):
            what = "first-token" if step == 0 else f"step-{step}"
            check(bool(torch.isfinite(got).all()), f"non-finite {what} "
                  f"logits")
            err = (got.float().cpu() - ref).abs().max().item()
            check(err <= LOGIT_TOL[cfg.dtype], f"{cfg.dtype} {what} logits "
                  f"differ from the CPU plain path by {err} > "
                  f"{LOGIT_TOL[cfg.dtype]}")
            errs.append({"prompt_len": len(p), "step": step, "err": err})
            if step == LOGIT_STEPS:
                break
            tok = ref.argmax(dim=-1).to(torch.int32)
            got, card_st = card_dec.raw_step(card_params, card_st,
                                             tok.to(device))
            ref, ref_st = ref_dec.raw_step(ref_params, ref_st, tok)
    return errs


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
    for name, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] nvcc -gencode arch=compute_90a,code=sm_90a: "
          f"{ {k: round(v, 2) for k, v in built.items()} } "
          f"(wall {build_s:.2f}s)")

    from repro_torch.config import get_config
    from repro_torch.launch import serve
    cfg41 = get_config("tconst-41m")
    dev = torch.device("cuda")
    max_len = serve.sessions_max_len(serve.parse_args(SESSIONS_ARGS))

    # 3. kernels vs plain
    rows = kernel_phase(torch, cfg41, dev, max_len)

    # 4. serve at full width: bf16 is the counted main path
    cfg, args, params, rep_bf16, counts = serve_phase(torch, runtime, serve,
                                                      "bfloat16")
    logit_err_bf16 = logits_phase(torch, serve, cfg, args, params)
    cfg32, args32, params32, rep_f32, counts32 = serve_phase(
        torch, runtime, serve, "float32")
    logit_err_f32 = logits_phase(torch, serve, cfg32, args32, params32)
    for dname, c, errs in (("bf16", counts, logit_err_bf16),
                           ("f32", counts32, logit_err_f32)):
        first = max(e["err"] for e in errs if e["step"] == 0)
        steps = max(e["err"] for e in errs if e["step"] > 0)
        print(f"[serve] {dname} sessions launches {c}; logits max err vs "
              f"the CPU f32 plain path: first token {first:.3e}, "
              f"{LOGIT_STEPS} decode steps {steps:.3e} (tol "
              f"{LOGIT_TOL['bfloat16' if dname == 'bf16' else 'float32']})")
    print("[serve] f32 greedy session streams match their solo runs")

    # 5. uniform batch engine (bf16)
    eargs = serve.parse_args(ENGINE_ARGS)
    ecfg, eapi, eparams = serve.load(eargs)
    erep = serve.run_batch(ecfg, eapi, eparams, eargs)
    check(erep["hit_ms"] is not None and erep["miss_ms"] is not None,
          "engine run recorded no warm hit or miss")

    # 6. report
    def pick(kernel, case):
        return next(r for r in rows if r["kernel"] == kernel and
                    r["case"] == case and r["dtype"] == "bfloat16")

    line = []
    for name, case, src, repl in (
            ("decode_attention", "self_full",
             "src/repro_torch/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:108"),
            ("flash_attention", "compress",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:116")):
        r = pick(name, case)
        line.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": counts[name]["kernel"],
            "max_abs_err": max(x["max_abs_err"] for x in rows
                               if x["kernel"] == name),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    detail = {
        "card": card, "kind": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": built,
        "kernel_rows": rows,
        "sessions_bf16": {"launches": counts, "seconds":
                          rep_bf16["seconds"], "sessions": [
                              {k: s[k] for k in ("sid", "prompt_len",
                                                 "resyncs", "matches")}
                              for s in rep_bf16["sessions"]],
                          "logit_err": logit_err_bf16},
        "sessions_f32": {"launches": counts32, "seconds":
                         rep_f32["seconds"], "logit_err": logit_err_f32},
        "engine_bf16": {k: erep[k] for k in ("hit_ms", "miss_ms", "n_hits",
                                              "n_misses", "miss_samples_ms",
                                              "seconds")},
        "total_s": time.time() - t_start,
    }
    (OUT / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(f"[done] {time.time() - t_start:.1f}s")
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
