#!/usr/bin/env python3
"""The counts of ``chip_smoke.py``'s tiering runs (phase 4e), predicted on
the CPU, and the bytes each spill moves at full width.

    PYTHONPATH=src python tools/torch_tier_counts.py

Spills, resumes, retired and re-adopted prefix pages, admission-cache puts
and hits, the tokens each admission forwards and each session's resyncs
are a function of the schedule: the argv's lengths, slots, chunks and
pages, and the TConst windows.  So each run of the phase is served here at
reduced widths (the model's own W_oh / W_og kept) on the CPU, with the
phase's argv.  Each spill's host bytes then follow from the full-width
state's shapes (``chip_smoke.snapshot_bytes`` of the tokens the session
held when it spilled; meta tensors: nothing is allocated).  Prints one
line per run.  Takes ~2 minutes on one CPU core.
"""
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def run(serve, CS, arch, argv, **over) -> dict:
    import torch
    from repro_torch import config as C
    from repro_torch.models.api import build_decode, build_model
    full = C.get_config(arch).replace(**over)
    keep = {"tconst": full.tconst} \
        if full.attention_mode in ("tconst", "tlin") else {}
    args = serve.parse_args(argv + ["--device", "cpu"])
    small = C.reduced(full, **keep).replace(dtype=args.dtype)
    api = build_model(small, device="cpu")
    served = serve.serve_sessions(small, api, api.init(0), args)
    sched = served["sched"]
    dec = build_decode(full.replace(dtype=args.dtype),
                       serve.layout_spec(args), device="cpu")
    meta = dataclasses.replace(dec, device=torch.device("meta"))
    sched.state = meta.init_state(args.slots, serve.sessions_max_len(args))
    per_spill = [CS.snapshot_bytes(sched, s.tokens)
                 for s in sched.stats if s.kind == "spill"]
    return {"arch": arch, **over, "dtype": args.dtype,
            **sched.spill_stats, "full_width_spilled_bytes": sum(per_spill),
            "full_width_bytes_per_spill": sorted(set(per_spill)),
            "forward_tokens": [a.forward_tokens for a in sched.admit_stats],
            "resyncs": [sched.resyncs[s.sid] for s in served["sessions"]]}


def main() -> int:
    import torch
    import chip_smoke as CS
    from repro_torch.launch import serve
    torch.set_num_threads(1)
    base = CS.SESSIONS_ARGS + ["--arch", "tconst-41m", "--layout", "dense"]
    runs = [("tconst-41m", base + ["--dtype", d] + CS.TIER_DENSE_ARGS,
             {"attention_mode": "tconst"}) for d in ("bfloat16", "float32")]
    runs += [("tconst-41m", CS.sharing_argv("tlin", "paged_int8", d) +
              CS.TIER_PAGED_ARGS, {"attention_mode": "tlin"})
             for d in ("bfloat16", "float32")]
    runs += [(CS.SMOLLM, CS.sharing_argv("smollm", "paged", "float32") +
              CS.TIER_SMOLLM_ARGS, {"n_layers": CS.SMOLLM_F32_DEPTH}),
             (CS.SMOLLM, CS.sharing_argv("smollm", "paged", "bfloat16") +
              CS.TIER_SMOLLM_ARGS + CS.TIER_SMOLLM_BF16, {})]
    for arch, argv, over in runs:
        print(json.dumps(run(serve, CS, arch, argv, **over)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
