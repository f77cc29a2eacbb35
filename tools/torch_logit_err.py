#!/usr/bin/env python3
"""The CPU plain path's own bf16-against-f32 logit error, at full width.

    PYTHONPATH=src python tools/torch_logit_err.py [--arch mamba2_130m]
        [--arch smollm-360m] [--arch tconst-41m --mode full]

Runs ``chip_smoke.py``'s logit check with both sides on the CPU: the
plain PyTorch path in bf16 against the same path in f32, same weights
(the port's seeded init), on the first ``--prompts`` session prompts of
the smoke (600 and 605 tokens), for the first token and ``LOGIT_STEPS``
decode steps fed the f32 path's greedy tokens.  It prints the largest
error of each -- the floor a card's bf16 logits cannot beat, from which
the smoke's bf16 tolerance of a family is set.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    import torch

    import chip_smoke as CS
    from repro_torch.launch import serve
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=CS.SSM)
    ap.add_argument("--mode", default="",
                    help="attention mode override (full: the base "
                         "transformer of tconst-41m)")
    ap.add_argument("--prompts", type=int, default=2)
    ap.add_argument("--threads", type=int, default=1,
                    help="CPU threads (many threads slow CPU bf16 down)")
    args_ = ap.parse_args(argv)
    torch.set_num_threads(args_.threads)
    args = serve.parse_args(CS.SESSIONS_ARGS + [
        "--arch", args_.arch, "--dtype", "bfloat16", "--device", "cpu"])
    cfg, _, params = serve.load(
        args, **({"attention_mode": args_.mode} if args_.mode else {}))
    errs = CS.logits_phase(torch, serve, cfg, args, params, float("inf"),
                           n_prompts=args_.prompts, device="cpu")
    first = max(e["err"] for e in errs if e["step"] == 0)
    steps = max(e["err"] for e in errs if e["step"] > 0)
    print(json.dumps({"arch": cfg.name, "errs": errs}))
    print(f"[logit_err] {cfg.name} {cfg.attention_mode} CPU bf16 vs CPU "
          f"f32 plain path: "
          f"first token {first}, {CS.LOGIT_STEPS} steps {steps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
