#!/usr/bin/env python3
"""The chunk-unit numbers of ``chip_smoke.py``'s workload runs (phase 4f),
predicted on the CPU.

    PYTHONPATH=src python tools/torch_workload_counts.py

TTFT, inter-token gaps and queue waits in chunks (p50 / p99), SLO
attainment, spills, resumes, admission sources and forward tokens, the
policy's deferrals, the sessions that cross a resync and the final clock
are a function of the trace and the schedule: no session has an EOS, so
no token value changes the schedule.  So each run of ``WORKLOAD_RUNS`` is
replayed here under both policies with ``chip_smoke.workload_run`` at
reduced widths (``reduced()``), keeping what the schedule reads: the
full vocabulary (the trace's draws), the TConst windows (W_oh / W_og),
the page size, the pool and the chunk sizes.  Prints one JSON line per
run and policy, then the ``WORKLOAD_PREDICTION`` dict that
``chip_smoke.py`` holds its f32 runs to.  Takes ~1 minute on one CPU core.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import torch
    import chip_smoke as CS
    from repro_torch import config as C
    from repro_torch import runtime
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    torch.set_num_threads(1)
    pred = {}
    for name, run in CS.WORKLOAD_RUNS.items():
        arch, over = CS.MODELS[run["mode"]]
        full = C.get_config(arch).replace(**over)
        keep = {"tconst": full.tconst} \
            if full.attention_mode in ("tconst", "tlin") else {}
        small = C.reduced(full, vocab_size=full.vocab_size, dtype="float32",
                          **keep)
        params = build_model(small, device="cpu").init(0)
        for policy in CS.WORKLOAD_POLICIES:
            rep = CS.workload_run(torch, runtime, serve, small, params, name,
                                  policy, device="cpu")
            pred[f"{name}/{policy}"] = CS.chunk_units(rep)
            print(json.dumps({"run": f"{name}/{policy}",
                              **pred[f"{name}/{policy}"],
                              "spill_cost_bytes_reduced":
                              rep["spill_cost_bytes"],
                              "spill_cost_readmit_reduced":
                              rep["spill_cost_readmit"],
                              "spill_stats": rep["spill_stats"],
                              "page_waits": rep["page_waits"],
                              "cpu_seconds": round(rep["seconds"], 1)}),
                  flush=True)
    print("WORKLOAD_PREDICTION = " + json.dumps(pred))
    return 0


if __name__ == "__main__":
    sys.exit(main())
