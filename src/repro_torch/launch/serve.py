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

``--prefix-sharing`` (with ``--sessions`` and a paged layout) serves
sessions whose prompts share one system prompt of ``--prompt-len``
tokens plus a distinct 8-token tail each: they are admitted up front,
map the resident pages of the shared prefix (refcounted, copy-on-write
before a resync) and print how many pages are shared::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_405b \\
      --reduced --device cpu --sessions 3 --slots 3 --gen 8 \\
      --prompt-len 32 --layout paged --page-size 16 --prefix-sharing \\
      --chunk 4

``--prefill-chunk N`` (with ``--sessions``; on a paged layout a multiple
of ``--page-size``) admits each prompt in fixed chunks of N tokens that
attend the KV already in the slot: with ``--prefix-sharing`` a sharing
admission forwards its unshared tail only, and every admission has the
chunk's shape (the TConst family buckets its admission at ``max_len``
instead).  It prints the tokens each admission forwarded::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --reduced --device cpu --sessions 4 --slots 4 --gen 16 \\
      --prompt-len 64 --layout paged --page-size 16 --prefix-sharing \\
      --prefill-chunk 16

``--spill-capacity-mb N`` (with ``--sessions``) attaches a tier store
of N MiB of host RAM (``--spill-dir DIR``: an mmap'd disk tier below it)
and preempts a slot that has decoded one chunk whenever sessions wait:
the session spills to the host and later resumes into any free slot.
Sessions are submitted up front, so the queue is oversubscribed; it
prints the ``tiering:`` lines and checks that each excess session
completed a spill->resume cycle (the exit code counts it)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tconst-41m \\
      --reduced --device cpu --sessions 6 --slots 2 --gen 16 \\
      --layout paged --page-size 16 --spill-capacity-mb 64

``--workload poisson|bursty`` (with ``--sessions N``) replays a seeded
traffic trace of N sessions -- arrivals in scheduler chunks, prompt and
output length mixes, a repeat slice, an SLO slice with a TTFT deadline of
``--slo-ttft-chunks`` -- through the scheduler under ``--policy fifo|slo``
and prints the telemetry summary (TTFT, inter-token gaps and queue waits
in chunks, SLO attainment, spills) and ``workload drained: ok``.  The
trace is a function of the argv and ``--seed``, so the two policies
replay the same sessions, and their streams are equal (a policy never
touches sampling)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tconst-41m \\
      --reduced --device cpu --sessions 8 --slots 2 --chunk 4 \\
      --max-len 104 --workload bursty --policy slo --slo-ttft-chunks 6

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
import json
import time
from typing import Any, Dict, List, Sequence

import numpy as np

from repro_torch.config import get_config, reduced
from repro_torch.models.api import build_decode, build_model
from repro_torch.models.layouts import LayoutSpec
from repro_torch.serving.engine import Engine, device_sync
from repro_torch.serving.metrics import ServingTelemetry
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.session import Session
from repro_torch.serving.tier_store import TierStore
from repro_torch.serving.workload import (Arrival, WorkloadSpec,
                                          generate_workload)

_FEATURES = "ROADMAP Queue 1 item 8 (serving features)"
# flag dest -> (default, where it is ported)
UNPORTED = {
    "speculate": (0, _FEATURES + ": speculative decoding"),
    "drafter": ("ngram", _FEATURES + ": speculative decoding"),
    "mesh": ("", "ROADMAP Queue 1 item 12 (multi-device)"),
}


def session_prompt_lens(args) -> List[int]:
    """Prompt lengths the sessions demo submits: they vary per session so
    slots sit at staggered resync phases.  Under prefix sharing: one
    common system prompt plus an 8-token tail each, all of one length
    (equal lengths keep prefill bit-reproducible, so greedy streams
    match their solo runs exactly)."""
    if args.prefix_sharing:
        return [args.prompt_len + 8] * args.sessions
    return [args.prompt_len + 5 * i for i in range(args.sessions)]


def session_prompts(cfg, args) -> List[np.ndarray]:
    rng = np.random.RandomState(args.seed)
    lens = session_prompt_lens(args)
    if args.prefix_sharing:
        common = rng.randint(1, cfg.vocab_size,
                             size=args.prompt_len).astype(np.int32)
        return [np.concatenate([common, rng.randint(
            1, cfg.vocab_size, size=n - args.prompt_len).astype(np.int32)])
            for n in lens]
    return [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


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
    if args.prefix_sharing:
        if not args.sessions:
            ap.error("--prefix-sharing needs --sessions N: the session "
                     "scheduler owns the prefix map and the page refcounts "
                     "(a uniform batch has no admission path)")
        if args.layout not in ("paged", "paged_int8"):
            ap.error(f"--prefix-sharing shares pool pages; --layout "
                     f"{args.layout} has none (use paged or paged_int8)")
    if args.prefill_chunk < 0:
        ap.error(f"--prefill-chunk {args.prefill_chunk} must be positive (0 "
                 f"disables chunked admission)")
    if args.prefill_chunk:
        if not args.sessions:
            ap.error("--prefill-chunk shapes admissions; the uniform batch "
                     "has no admission path (its prefill is one piece "
                     "already): add --sessions N")
        if args.layout in ("paged", "paged_int8") and \
                args.prefill_chunk % args.page_size != 0:
            ap.error(f"--prefill-chunk {args.prefill_chunk} must be a "
                     f"multiple of --page-size {args.page_size}: "
                     f"chunk-granular page writes cover whole pages")
    if args.workload and not args.sessions:
        ap.error("--workload replays a traffic trace through the session "
                 "scheduler (arrivals, SLOs and policies are admission-side "
                 "concepts; the uniform batch has none): add --sessions N")
    if args.slo_ttft_chunks < 1:
        ap.error(f"--slo-ttft-chunks {args.slo_ttft_chunks} must be >= 1 "
                 f"(the deadline is counted in scheduler chunks from "
                 f"submission)")
    if args.spill_capacity_mb < 0:
        ap.error(f"--spill-capacity-mb {args.spill_capacity_mb} must be "
                 f"positive (0 disables session tiering)")
    if (args.spill_capacity_mb or args.spill_dir) and not args.sessions:
        ap.error("--spill-capacity-mb/--spill-dir tier per-session slot "
                 "state; the uniform batch has no sessions to spill: add "
                 "--sessions N")
    if args.spill_dir and not args.spill_capacity_mb:
        ap.error("--spill-dir is the tier below a bounded host-RAM store: "
                 "demotions to disk only happen when --spill-capacity-mb "
                 "caps the RAM tier, so without it the directory would "
                 "stay empty.  Size the cap in the layout's physical "
                 "bytes: paged layouts spill only each session's live "
                 "pages and int8 snapshots stay compressed")
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


def tier_store(args) -> Any:
    """The ``--spill-capacity-mb`` / ``--spill-dir`` store (None without
    a capacity)."""
    if not args.spill_capacity_mb:
        return None
    return TierStore(capacity_bytes=int(args.spill_capacity_mb * (1 << 20)),
                     spill_dir=args.spill_dir or None)


def serve_sessions(cfg, api, params, args) -> Dict[str, Any]:
    """Continuous-batching demo: N sessions with different prompt lengths
    admitted at staggered times into a fixed-slot batch (under prefix
    sharing or tiering: submitted up front).  Returns a report:
    ``prompts``, the served ``Session``s, the scheduler, the seconds it
    took, ``sharing``, the :func:`sharing_report` of the first admissions
    (None without prefix sharing), and ``tiering``, the
    :func:`tiering_report` (None without a store).  Runs nothing but the
    scheduler's own path."""
    prompts = session_prompts(cfg, args)
    paged_layout_note(cfg, args)
    decode = build_decode(cfg, layout_spec(args), device=api.device,
                          prefill_chunk=args.prefill_chunk or None)
    store = tier_store(args)
    sched = SlotScheduler(decode, params, slots=args.slots,
                          max_len=sessions_max_len(args),
                          chunk_size=args.chunk, seed=args.seed,
                          prefix_sharing=args.prefix_sharing,
                          tier_store=store,
                          preempt_chunks=1 if store is not None else None)

    def stream(sess, tok):
        print(f"[serve]   session {sess.sid}: token[{len(sess.tokens) - 1}]"
              f" = {tok}")

    t0 = time.time()
    sessions = []
    sharing = None
    for p in prompts:
        sessions.append(sched.submit(Session(
            p, max_new_tokens=args.gen, temperature=args.temperature,
            eos_id=args.eos if args.eos >= 0 else None,
            on_token=stream if args.verbose else None)))
        # staggered admission: one chunk between submissions, so slots sit
        # at different W_og resync phases.  Prefix sharing admits up front
        # instead: sessions in flight together keep the prefix resident.
        # So does tiering: staggering would drain the queue one session a
        # chunk, and the oversubscription spills exist for never builds
        if not args.prefix_sharing and store is None:
            sched.step()
    if args.prefix_sharing:
        sched.admit_pending()
        sharing = sharing_report(sched)
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
    if sched.prefill_chunk:
        tagged = sum(1 for s in sched.admit_stats if s.compiled)
        fwd = [s.forward_tokens for s in sched.admit_stats]
        print(f"[serve] chunked prefill (chunk={sched.prefill_chunk}): "
              f"forward tokens per admission {fwd} (prompt lengths "
              f"{[len(p) for p in prompts]}); {tagged} compile-tagged "
              f"admission(s) across {len(set(len(p) for p in prompts))} "
              f"distinct lengths")
    print(f"[serve] KV-cache bytes ({args.slots} slots, "
          f"{sched.layout.name} layout): {sched.kv_bytes()}")
    if sched._paged:
        print(f"[serve] paged pool: {sched.layout.pool_pages} pages of "
              f"{sched.layout.page} tokens (+1 trash) for {args.slots} slots"
              f" x {sched.layout.pages_per_slot} pages/slot; "
              f"{sched.page_waits} admission round(s) waited for pages; "
              f"up to {sched.peak_active} sessions decoded at once")
    tiering = tiering_report(sched, sessions, args) \
        if store is not None else None
    return {"prompts": prompts, "sessions": sessions, "sched": sched,
            "seconds": dt, "sharing": sharing, "tiering": tiering}


def drive(sched: SlotScheduler, arrivals: Sequence[Arrival]) -> float:
    """Open-loop replay of a trace: each session is submitted once the
    scheduler's clock reaches its ``at_chunk``, and the scheduler steps
    until every session drains.  Raises past 20k chunks (a stuck
    scheduler).  Returns the wall seconds, the device synced."""
    t0 = time.time()
    i = 0
    while i < len(arrivals) or sched.pending or sched.active.any():
        while i < len(arrivals) and arrivals[i].at_chunk <= sched.clock:
            sched.submit(arrivals[i].session)
            i += 1
        sched.step()
        if sched.clock > 20_000:
            raise RuntimeError("workload did not drain within 20000 chunks:"
                               " the scheduler is stuck")
    device_sync(sched.device)
    return time.time() - t0


def run_workload(cfg, api, params, args) -> Dict[str, Any]:
    """SLO-aware scheduling demo: replay the seeded ``--workload`` trace
    through the scheduler under ``--policy`` and print the telemetry
    summary.  The trace (JAX's launcher's: N sessions, a fifth repeats
    of an earlier prompt, half with a TTFT deadline of
    ``--slo-ttft-chunks``; under prefix sharing a quarter behind one of
    two page-long system prompts) is a function of the argv and
    ``--seed``, so another ``--policy`` replays the same sessions
    (prompts, arrival chunks, SLO targets, per-session sampling seeds)
    and the printed TTFT / ITL / SLO numbers compare across policies.  With
    ``--spill-capacity-mb`` the scheduler spills a slot that decoded a
    chunk whenever sessions wait.  Returns ``rc`` (0 when every session
    drained), the ``summary``, the ``arrivals`` and the scheduler."""
    spec = WorkloadSpec(
        n_sessions=args.sessions, vocab=cfg.vocab_size,
        arrival=args.workload, temperature=args.temperature,
        shared_frac=0.25 if args.prefix_sharing else 0.0,
        prefix_len=args.page_size if args.prefix_sharing else 16,
        repeat_frac=0.2, slo_frac=0.5,
        slo_ttft_chunks=args.slo_ttft_chunks)
    max_len = sessions_max_len(args)
    paged_layout_note(cfg, args)
    decode = build_decode(cfg, layout_spec(args), device=api.device,
                          prefill_chunk=args.prefill_chunk or None)
    store = tier_store(args)
    telemetry = ServingTelemetry()
    sched = SlotScheduler(decode, params, slots=args.slots, max_len=max_len,
                          chunk_size=args.chunk, seed=args.seed,
                          prefix_sharing=args.prefix_sharing,
                          tier_store=store,
                          preempt_chunks=1 if store is not None else None,
                          policy=args.policy, telemetry=telemetry)
    # headroom for the longest output draw (32) and one chunk of
    # over-generation, so every generated session is admissible
    arrivals = generate_workload(
        spec, args.seed, max_prompt_len=max(8, max_len - 40 - args.chunk))
    dt = drive(sched, arrivals)
    summary = telemetry.summary()
    total = summary["tokens_out"]
    print(f"[serve] arch={cfg.name} mode={cfg.attention_mode} "
          f"layout={sched.layout.name} device={sched.device} "
          f"workload={args.workload} policy={args.policy} served "
          f"{summary['sessions']} sessions ({total} tokens) on {args.slots} "
          f"slots in {dt:.2f}s ({total / dt:.1f} tok/s)")
    print(json.dumps(summary, indent=2, sort_keys=True))
    ok = summary["finished"] == summary["sessions"]
    print(f"[serve] workload drained: {'ok' if ok else 'FAIL'} "
          f"(clock={sched.clock} chunks)")
    return {"rc": 0 if ok else 1, "summary": summary, "arrivals": arrivals,
            "sched": sched}


def tiering_report(sched, sessions, args) -> Dict[str, Any]:
    """Print the ``tiering:`` lines of a run with a tier store (spills,
    resumes, snapshot bytes, the admission cache, retired / re-adopted
    prefix pages, per-session cycles, the store's tiers) and, when the
    sessions oversubscribe the slots, the cycle check: every excess
    session completed >= 1 spill->resume cycle.  Returns the numbers and
    ``ok``."""
    store = sched.store
    sp = sched.spill_stats
    print(f"[serve] tiering: {sp['spills']} spills / {sp['resumes']} "
          f"resumes ({sp['spilled_bytes']} snapshot bytes through the "
          f"host tier); admission cache {sp['admit_store_hits']} hits / "
          f"{sp['admit_store_puts']} puts; {sp['pages_retired']} prefix "
          f"pages retired / {sp['pages_readopted']} re-adopted")
    for s in sessions:
        print(f"[serve]   session {s.sid}: {s.spills} spills, {s.resumes} "
              f"resumes")
    print(f"[serve] tiering: assigned device KV bytes "
          f"{sched.assigned_kv_bytes()} vs host tier: "
          f"{store.occupancy_bytes} RAM + {store.disk_bytes} disk "
          f"({len(store)} blobs; {store.stats})")
    rep = {**sp, "store": dict(store.stats), "ok": True,
           "cycles": sum(1 for s in sessions if s.resumes >= 1),
           "per_session": [(s.spills, s.resumes) for s in sessions]}
    if args.sessions > args.slots:
        need = args.sessions - args.slots
        rep["ok"] = rep["cycles"] >= need
        print(f"[serve] tiering: {rep['cycles']} session(s) completed >= 1 "
              f"spill->resume cycle (oversubscribed by {need}): "
              f"{'ok' if rep['ok'] else 'FAIL'}")
    return rep


def sharing_report(sched) -> Dict[str, Any]:
    """Print the prefix-sharing line of the admissions so far (or, where
    the cache stores nothing in pages, the inert note) and return its
    numbers: ``shared`` pages (refcount > 1), ``assigned`` pages, the
    ``assigned_kv_bytes`` with the shared prefix counted once, and
    ``unshared_kv_bytes``, what the same table rows would hold with every
    reference its own page."""
    if not sched.prefix_sharing:
        print("[serve] note: this config stores nothing in pages -- prefix "
              "sharing is inert (see the paged-layout note)")
        return {"shared": 0, "assigned": 0}
    refs = sched.page_refcounts()
    assigned = int((refs > 0).sum())
    kv = sched.assigned_kv_bytes()
    page_bytes = 0                   # one page of every paged field
    for f, t in sched.state.kv.items():
        ax = sched.layout.page_axis(f)
        if ax is not None:
            page_bytes += t.numel() * t.element_size() // t.shape[ax]
    rep = {"shared": int((refs > 1).sum()), "assigned": assigned,
           "assigned_kv_bytes": kv,
           "unshared_kv_bytes": kv + (int(refs.sum()) - assigned) *
           page_bytes}
    print(f"[serve] prefix sharing: {rep['shared']} shared pages (refcount "
          f"> 1), {assigned} assigned of {sched.layout.pool_pages} pool "
          f"pages; assigned KV bytes (shared prefix counted once): {kv}")
    return rep


def check_sessions(api, params, served, args) -> Dict[str, Any]:
    """Per-session records of a ``serve_sessions`` report; under greedy
    sampling without EOS each stream must match its own single-session
    generation (an Engine run per session).  ``rc`` is 0 when every
    check passed."""
    sched = served["sched"]
    ok = served.get("tiering") is None or served["tiering"]["ok"]
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
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="refcounted page sharing of a common system "
                         "prompt, copy-on-write (sessions mode, paged "
                         "layouts)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked, KV-conditioned admission (sessions "
                         "mode): prompts in chunks of N tokens (paged "
                         "layouts: a multiple of the page size); with "
                         "prefix sharing a sharing admission forwards its "
                         "unshared tail only; 0: one-shot")
    ap.add_argument("--spill-capacity-mb", type=float, default=0.0,
                    help="session tiering (sessions mode): a host-RAM tier "
                         "store of this many MiB; sessions beyond the slots "
                         "spill to it and resume (0: off)")
    ap.add_argument("--spill-dir", default="",
                    help="an mmap'd disk tier below the RAM tier (needs "
                         "--spill-capacity-mb)")
    ap.add_argument("--workload", default="",
                    choices=["", "poisson", "bursty"],
                    help="replay a seeded traffic trace of --sessions N "
                         "(poisson or bursty arrivals, length mixes, an SLO "
                         "slice) under --policy and print the telemetry "
                         "summary")
    ap.add_argument("--policy", default="fifo", choices=["fifo", "slo"],
                    help="admission and victim policy (workload mode): fifo "
                         "= arrival order; slo = deadline- and cost-aware "
                         "(TTFT-slack admission order, cheapest victims)")
    ap.add_argument("--slo-ttft-chunks", type=int, default=8,
                    help="TTFT deadline, in scheduler chunks from "
                         "submission, of the workload's SLO slice")
    # features of the JAX launcher that are not ported yet
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
    if args.workload:
        return run_workload(cfg, api, params, args)["rc"]
    if args.sessions:
        served = serve_sessions(cfg, api, params, args)
        return check_sessions(api, params, served, args)["rc"]
    return run_batch(cfg, api, params, args)["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
