#!/usr/bin/env python3
"""The CPU plain path's own bf16-against-f32 logit error, at full width.

    PYTHONPATH=src python tools/torch_logit_err.py [--arch mamba2_130m]
        [--arch smollm-360m] [--arch tconst-41m --mode full]
        [--arch deepseek_moe_16b --layers 3]
        [--arch deepseek_moe_16b --mode tconst --layers 8 --prompt-len 700]
        [--arch whisper_small]
        [--arch hymba_1_5b --layers 4 --prompt-len 1060 --prompts 1]
        [--arch qwen2_vl_2b --layers 4]

Runs ``chip_smoke.py``'s logit check with both sides on the CPU: the
plain PyTorch path in bf16 against the same path in f32, same weights
(the port's seeded init in f32; the bf16 path casts them), on the first
``--prompts`` session prompts of the smoke (600 and 605 tokens; 700 and
705 with ``--prompt-len 700``, those of deepseek's tconst runs), for the
first token and ``LOGIT_STEPS`` decode steps fed the f32 path's greedy
tokens.  It prints the largest error of each -- the floor a card's bf16
logits cannot beat, from which the smoke's bf16 tolerance of a family is
set -- and, for an MoE model, how many routed tokens (token x MoE layer)
chose another expert set in bf16 than in f32.  ``--layers`` cuts the
depth (deepseek's logits are checked at 3 layers: the dense one and two
MoE layers).  ``--arch whisper_small`` runs the smoke's enc-dec check
instead (``chip_smoke.encdec_logits``): the phase's first session (its
own audio frames) on the four layouts; ``--arch qwen2_vl_2b`` the VLM's
(``chip_smoke.vlm_logits``): phase 4h's first session (its own patches in
the prompt) on the int8 layout, each side stepping on from the other's
stored cache.  ``--arch hymba_1_5b`` takes the LM path above (phase 4h
checks its logits on its first dense prompt, 1060 tokens, at 4 layers).
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
    ap.add_argument("--layers", type=int, default=0,
                    help="model depth (default: the config's)")
    ap.add_argument("--prompt-len", default="600",
                    help="the first session prompt's length")
    args_ = ap.parse_args(argv)
    torch.set_num_threads(args_.threads)
    args = serve.parse_args(CS.SESSIONS_ARGS + [
        "--arch", args_.arch, "--dtype", "float32", "--device", "cpu",
        "--prompt-len", args_.prompt_len])
    over = {"attention_mode": args_.mode} if args_.mode else {}
    if args_.layers:
        over["n_layers"] = args_.layers
    cfg, _, params = serve.load(args, **over)
    cfg = cfg.replace(dtype="bfloat16")
    if cfg.is_encdec:
        prompts, audio = CS.encdec_inputs(cfg)
        errs = CS.encdec_logits(torch, cfg, params, prompts[0], audio[0],
                                CS.ENCDEC_LAYOUTS, float("inf"),
                                device="cpu")
        print(f"[logit_err] {cfg.name} CPU bf16 vs CPU f32 plain path, "
              f"the admission and {CS.LOGIT_STEPS} steps, largest error "
              f"by layout: {errs}")
        return 0
    if cfg.arch_type == "vlm":
        err, adopted = CS.vlm_logits(torch, cfg, params, "int8",
                                     float("inf"), device="cpu")
        print(f"[logit_err] {cfg.name} ({cfg.n_layers} layers) CPU bf16 vs "
              f"CPU f32 plain path on int8, the admission and "
              f"{CS.LOGIT_STEPS} steps: largest error {err} ({adopted} codes "
              f"adopted)")
        return 0
    errs = CS.logits_phase(torch, serve, cfg, args, params, float("inf"),
                           n_prompts=args_.prompts, device="cpu")
    s = CS.summarize(errs)
    print(json.dumps({"arch": cfg.name, "n_layers": cfg.n_layers,
                      "errs": errs}))
    print(f"[logit_err] {cfg.name} {cfg.attention_mode} ({cfg.n_layers} "
          f"layers) CPU bf16 vs CPU f32 plain path: first token "
          f"{s['first']}, {CS.LOGIT_STEPS} steps {s['steps']}; routed "
          f"tokens whose expert set differs: {s['route_flips']} of "
          f"{s['routed']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
