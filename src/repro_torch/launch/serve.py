"""Serving launcher of the port: uniform-batch generation (Engine) or
session-based streaming (SlotScheduler) with continuous batching.

Runs on ``cuda`` unless ``--device cpu`` is given (no GPU and no
``--device cpu``: it raises).  On CUDA every attention and SSD scan runs
on the hand-written kernels; on the CPU on their plain versions.

Uniform batch (prints the mean cache-hit step and resync times)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tconst-41m \\
      --reduced --prompt-len 64 --gen 64 --batch 4 --device cpu

Streaming sessions (staggered admission, per-session prompt lengths;
each greedy stream is checked against its own solo run on the same
layout)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tconst-41m \\
      --reduced --sessions 3 --slots 2 --gen 24 --device cpu

``--arch mamba2_130m`` serves the SSM family (K4 at admission, the O(1)
recurrent step after it; no resync)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_130m \\
      --reduced --sessions 3 --slots 2 --gen 24 --device cpu

``--arch smollm-360m`` serves a dense attention LM (K2 at admission, K1
on the dense layout, K1-int8 / K3 / K3-int8 on the others; no resync);
the paper's base transformer is ``tconst-41m`` in ``full`` mode on the
tconst weights (``load(args, attention_mode="full")``; the JAX launcher
has no mode flag, so this one has none)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --reduced --sessions 3 --slots 2 --gen 24 --device cpu

``--arch deepseek_moe_16b`` and ``--arch mixtral_8x22b`` serve the MoE
family the same way (its routing and expert products are PyTorch, as
they are XLA in JAX; deepseek-moe-16b fits one 80 GB card at full width,
mixtral-8x22b only ``--reduced``)::

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek_moe_16b --reduced --sessions 3 --slots 2 --gen 24 \\
      --device cpu

``--layout dense|int8|paged|paged_int8`` picks the cache layout
(``--page-size``, ``--pool-pages``: a pool below ``slots x pages_per_slot``
needs ``--sessions``, whose scheduler allocates pages).  The tconst
configs of the registry run in tconst mode, whose O(1) cache has nothing
to page; the paged layouts page TLinFormer's history KV
(``attention_mode="tlin"``, built by the caller of :func:`load`) and a
dense LM's whole KV cache.  The SSM
state has no length axis and is never quantized: every layout holds it
dense, as in the JAX package.

Flags of features not ported yet are kept and refused with the ROADMAP
item that ports them.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List

import numpy as np

from repro_torch.config import get_config, reduced
from repro_torch.models.api import build_decode, build_model
from repro_torch.models.layouts import LayoutSpec
from repro_torch.serving.engine import Engine, device_sync
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.session import Session

_FEATURES = "ROADMAP Queue 1 item 8 (serving features)"
# flag dest -> (default, where it is ported)
UNPORTED = {
    "prefix_sharing": (False, _FEATURES + ": prefix sharing"),
    "prefill_chunk": (0, _FEATURES + ": chunked admission"),
    "spill_capacity_mb": (0.0, _FEATURES + ": session tiering"),
    "spill_dir": ("", _FEATURES + ": session tiering"),
    "workload": ("", _FEATURES + ": workload, telemetry and policies"),
    "policy": ("fifo", _FEATURES + ": workload, telemetry and policies"),
    "slo_ttft_chunks": (8, _FEATURES + ": workload, telemetry and policies"),
    "speculate": (0, _FEATURES + ": speculative decoding"),
    "drafter": ("ngram", _FEATURES + ": speculative decoding"),
    "mesh": ("", "ROADMAP Queue 1 item 12 (multi-device)"),
}


def session_prompt_lens(args) -> List[int]:
    """Prompt lengths the sessions demo submits: they vary per session so
    slots sit at staggered resync phases."""
    return [args.prompt_len + 5 * i for i in range(args.sessions)]


def session_prompts(cfg, args) -> List[np.ndarray]:
    rng = np.random.RandomState(args.seed)
    return [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
            for n in session_prompt_lens(args)]


def sessions_max_len(args) -> int:
    return args.max_len or (max(session_prompt_lens(args)) + args.gen + 64)


def batch_max_len(args) -> int:
    return args.max_len or (args.prompt_len + args.gen + 64)


def layout_spec(args, full_pool: bool = False) -> LayoutSpec:
    """The ``--layout`` / ``--page-size`` / ``--pool-pages`` choice
    (``full_pool``: the same kind with the full pool, as a solo run or a
    uniform batch needs)."""
    return LayoutSpec(kind=args.layout, page_size=args.page_size,
                      pool_pages=None if full_pool else
                      (args.pool_pages or None))


def validate_layout_args(ap, args, max_len: int) -> None:
    """Startup validation of the paged-layout knobs against the launch
    geometry, so a mis-sized pool fails with a clear message instead of a
    shape error (or a scheduler rejection) at the first admission."""
    if args.layout not in ("paged", "paged_int8") or not args.pool_pages:
        return                       # full pool: always valid, no allocator
    if args.page_size < 1 or args.pool_pages < 0:
        ap.error("--page-size and --pool-pages must be positive")
    pages_per_slot = -(-max_len // args.page_size)
    slots = args.slots if args.sessions else args.batch
    full_pool = slots * pages_per_slot
    if args.pool_pages > full_pool:
        ap.error(
            f"--pool-pages {args.pool_pages} exceeds the full pool: "
            f"{slots} slots x {pages_per_slot} pages/slot "
            f"(max_len {max_len} / page {args.page_size}) = {full_pool} "
            f"pages -- lower it or drop it for the full pool")
    if not args.sessions and args.pool_pages < full_pool:
        ap.error(
            f"--pool-pages {args.pool_pages} < full pool {full_pool} needs "
            f"the sessions-mode page allocator (uniform-batch prefill "
            f"cannot place rows in an under-sized pool); add --sessions N "
            f"or drop --pool-pages")
    # the largest session this launcher submits must be admissible
    worst_prompt = max(session_prompt_lens(args)) if args.sessions \
        else args.prompt_len
    worst_need = -(-(worst_prompt + args.gen + args.chunk)
                   // args.page_size)
    if worst_need > args.pool_pages:
        ap.error(
            f"--pool-pages {args.pool_pages} cannot admit the largest "
            f"session: prompt {worst_prompt} + gen {args.gen} + headroom "
            f"{args.chunk} needs {worst_need} pages of {args.page_size} "
            f"tokens -- raise --pool-pages to >= {worst_need} or shrink "
            f"the sessions")


def paged_layout_note(cfg, args) -> None:
    """Pure tconst KV is O(1): nothing has a length axis, so a paged
    layout stores nothing in pages for it (tlin does page)."""
    if args.layout in ("paged", "paged_int8") and \
            cfg.attention_mode == "tconst":
        print("[serve] note: pure tconst KV is O(1); the paged layout "
              "stores nothing in pages for this config (--page-size/"
              "--pool-pages are inert)")


def serve_sessions(cfg, api, params, args) -> Dict[str, Any]:
    """Continuous-batching demo: N sessions with different prompt lengths
    admitted at staggered times into a fixed-slot batch.  Returns a
    report: ``prompts``, the served ``Session``s, the scheduler and the
    seconds it took.  Runs nothing but the scheduler's own path."""
    prompts = session_prompts(cfg, args)
    paged_layout_note(cfg, args)
    decode = build_decode(cfg, layout_spec(args), device=api.device)
    sched = SlotScheduler(decode, params, slots=args.slots,
                          max_len=sessions_max_len(args),
                          chunk_size=args.chunk, seed=args.seed)

    def stream(sess, tok):
        print(f"[serve]   session {sess.sid}: token[{len(sess.tokens) - 1}]"
              f" = {tok}")

    t0 = time.time()
    sessions = []
    for p in prompts:
        sessions.append(sched.submit(Session(
            p, max_new_tokens=args.gen, temperature=args.temperature,
            eos_id=args.eos if args.eos >= 0 else None,
            on_token=stream if args.verbose else None)))
        # staggered admission: one chunk between submissions, so slots sit
        # at different W_og resync phases
        sched.step()
    sched.run()
    device_sync(sched.device)
    dt = time.time() - t0

    total = sum(len(s.tokens) for s in sessions)
    print(f"[serve] arch={cfg.name} mode={cfg.attention_mode} "
          f"layout={sched.layout.name} device={sched.device} "
          f"dtype={cfg.dtype} served "
          f"{len(sessions)} sessions ({total} tokens) on {args.slots} slots "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s)")
    chunks = [s for s in sched.stats if s.kind == "chunk"]
    if chunks:
        warm = [s.seconds for s in chunks if not s.compiled] or \
            [s.seconds for s in chunks]
        print(f"[serve] decode chunks: n={len(chunks)} ({args.chunk} "
              f"tokens/chunk) median={np.median(warm) * 1e3:.2f}ms")
    admits = [s.seconds for s in sched.admit_stats if not s.compiled]
    if admits:
        print(f"[serve] admissions: n={len(sched.admit_stats)} "
              f"warm median={np.median(admits) * 1e3:.2f}ms")
    print(f"[serve] KV-cache bytes ({args.slots} slots, "
          f"{sched.layout.name} layout): {sched.kv_bytes()}")
    if sched._paged:
        print(f"[serve] paged pool: {sched.layout.pool_pages} pages of "
              f"{sched.layout.page} tokens (+1 trash) for {args.slots} slots"
              f" x {sched.layout.pages_per_slot} pages/slot; "
              f"{sched.page_waits} admission round(s) waited for pages; "
              f"up to {sched.peak_active} sessions decoded at once")
    return {"prompts": prompts, "sessions": sessions, "sched": sched,
            "seconds": dt}


def check_sessions(api, params, served, args) -> Dict[str, Any]:
    """Per-session records of a ``serve_sessions`` report; under greedy
    sampling without EOS each stream must match its own single-session
    generation (an Engine run per session).  ``rc`` is 0 when every
    check passed."""
    sched = served["sched"]
    ok = True
    records = []
    check = args.temperature <= 0.0 and args.eos < 0
    eng = Engine(api, params, max_len=sched.max_len,
                 layout=layout_spec(args, full_pool=True)) \
        if check else None
    for s, p in zip(served["sessions"], served["prompts"]):
        rec = {"sid": s.sid, "prompt_len": len(p), "tokens": list(s.tokens),
               "resyncs": sched.resyncs.get(s.sid, 0), "matches": None}
        line = (f"[serve]   session {s.sid} (prompt {len(p)}): "
                f"{len(s.tokens)} tokens, {rec['resyncs']} resyncs")
        if eng is not None:              # greedy: must match the solo run
            ref = eng.generate({"tokens": p[None]}, args.gen)[0].tolist()
            rec["matches"] = s.tokens == ref
            ok = ok and rec["matches"]
            line += f", matches solo run: {rec['matches']}"
        print(line)
        records.append(rec)
    return {"rc": 0 if ok else 1, "sessions": records, "sched": sched,
            "seconds": served["seconds"]}


def run_batch(cfg, api, params, args) -> Dict[str, Any]:
    """Uniform batch through the instrumented Engine path: each cache-hit
    step and each resync is timed on its own."""
    paged_layout_note(cfg, args)
    eng = Engine(api, params, max_len=batch_max_len(args),
                 sample_temperature=args.temperature, seed=args.seed,
                 layout=layout_spec(args))
    rng = np.random.RandomState(args.seed + 1)
    batch = {"tokens": rng.randint(0, cfg.vocab_size,
                                   size=(args.batch, args.prompt_len))}
    t0 = time.time()
    out = eng.generate(batch, args.gen, record_stats=True)
    dt = time.time() - t0
    prefill_ms = 1e3 * next(s.seconds for s in eng.stats
                            if s.kind == "prefill")
    hits = [s.seconds for s in eng.stats if s.kind == "hit" and
            not s.compiled]
    misses = [s.seconds for s in eng.stats if s.kind == "miss" and
              not s.compiled]
    print(f"[serve] arch={cfg.name} mode={cfg.attention_mode} "
          f"layout={args.layout} device={eng.device} dtype={cfg.dtype} "
          f"generated {out.shape} in "
          f"{dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)")
    print(f"[serve] prefill (admission of the batch): {prefill_ms:.3f}ms")
    if hits:
        print(f"[serve] cache-hit steps: n={len(hits)} "
              f"mean={np.mean(hits) * 1e3:.3f}ms")
    if misses:
        print(f"[serve] cache-miss resyncs (compacted row-wise): "
              f"n={len(misses)} mean={np.mean(misses) * 1e3:.3f}ms")
    print(f"[serve] KV-cache bytes @max_len ({args.layout} layout): "
          f"{eng.cache_bytes(args.batch)}")
    return {"rc": 0, "tokens": out, "prefill_ms": prefill_ms,
            "hit_ms": 1e3 * float(np.mean(hits))
            if hits else None, "miss_ms": 1e3 * float(np.mean(misses))
            if misses else None, "n_hits": len(hits),
            "n_misses": len(misses),
            "miss_samples_ms": [1e3 * m for m in misses], "seconds": dt}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tconst-41m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="",
                    choices=["", "bfloat16", "float32"],
                    help="activation dtype (default: the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eos", type=int, default=-1,
                    help="end-of-sequence id for sessions mode (< 0: off)")
    ap.add_argument("--sessions", type=int, default=0,
                    help="serve N streaming sessions (staggered admission, "
                         "variable prompt lengths) instead of one batch")
    ap.add_argument("--slots", type=int, default=2,
                    help="scheduler decode slots (sessions mode)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode tokens per chunk (sessions mode)")
    ap.add_argument("--verbose", action="store_true",
                    help="print every streamed token (sessions mode)")
    ap.add_argument("--layout", default="dense",
                    choices=["dense", "paged", "int8", "paged_int8"],
                    help="physical cache layout of the decode state")
    ap.add_argument("--page-size", type=int, default=64,
                    help="tokens per page (paged layouts)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="pages in the shared pool (paged layouts; 0: the "
                         "full slots x pages_per_slot pool; fewer needs "
                         "--sessions)")
    # features of the JAX launcher that are not ported yet
    ap.add_argument("--prefix-sharing", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--spill-capacity-mb", type=float, default=0.0)
    ap.add_argument("--spill-dir", default="")
    ap.add_argument("--workload", default="",
                    choices=["", "poisson", "bursty"])
    ap.add_argument("--policy", default="fifo", choices=["fifo", "slo"])
    ap.add_argument("--slo-ttft-chunks", type=int, default=8)
    ap.add_argument("--speculate", type=int, default=0)
    ap.add_argument("--drafter", default="ngram", choices=["ngram", "tconst"])
    ap.add_argument("--mesh", default="")
    return ap


def parse_args(argv=None, ap: argparse.ArgumentParser = None
               ) -> argparse.Namespace:
    """Parse ``argv`` with ``ap`` (default: ``build_parser()``; another
    launcher passes the parser it extended), refuse unported flags and
    validate the layout flags."""
    ap = ap or build_parser()
    args = ap.parse_args(argv)
    for dest, (default, item) in UNPORTED.items():
        if getattr(args, dest) != default:
            flag = "--" + dest.replace("_", "-")
            ap.error(f"{flag} is not ported to the PyTorch port yet: "
                     f"{item}")
    validate_layout_args(ap, args, sessions_max_len(args) if args.sessions
                         else batch_max_len(args))
    return args


def load(args, **overrides):
    """(cfg, api, params) for parsed ``args``: the port's seeded init.
    ``overrides`` replace config fields (e.g. ``attention_mode="tlin"``,
    the TLinFormer baseline on the same weights).  With ``--reduced`` they
    go into ``reduced``, which sizes the model by its attention mode (a
    full-mode config reduced into tconst mode is 2 blocks at W 8)."""
    cfg = get_config(args.arch)
    if args.dtype:
        overrides = {"dtype": args.dtype, **overrides}
    if args.reduced:
        cfg = reduced(cfg, **overrides)
    elif overrides:
        cfg = cfg.replace(**overrides)
    api = build_model(cfg, device=args.device)
    return cfg, api, api.init(args.seed)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg, api, params = load(args)
    if args.sessions:
        served = serve_sessions(cfg, api, params, args)
        return check_sessions(api, params, served, args)["rc"]
    return run_batch(cfg, api, params, args)["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
