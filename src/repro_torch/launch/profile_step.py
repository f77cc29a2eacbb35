"""Where a serving step's time goes: ``torch.profiler`` over the port's
cache-hit step, its resync and an admission.

  PYTHONPATH=src python -m repro_torch.launch.profile_step \\
      --arch tconst-41m --batch 4 --prompt-len 1024 --steps 20

It takes ``serve``'s flags (``--arch``, ``--layout``, ``--page-size``, ...
with the full pool) and ``--mode tlin`` for the TLinFormer baseline on
the same weights, whose hit step also reads the O(N) history KV (K3 on
the paged layouts), or ``--mode full`` for the base transformer, whose
step attends its whole O(N) KV cache (K1 / K3) and whose admission is
one causal K2 pass a layer.  ``--arch smollm-360m`` profiles a dense
attention LM the same way, ``--arch deepseek_moe_16b`` the MoE family
(its step routes the batch's tokens through every expert's weights);
``--arch mamba2_130m`` the SSM family: its step and its admission (K4
tiled at chunk 64, the prompt's last chunk ragged).  None of these has a
resync.

Prefills a uniform batch, warms up, then profiles ``--steps`` cache-hit
steps (one batched token each, ended by ``cuda.synchronize``), one
resync of every row (families with a periodic resync) and 3 admissions
of one ``--prompt-len`` prompt into slot 0 (``prefill_into_slot``).  For
each it prints the host wall time per call, the
summed device-kernel time per call, the device busy share (kernel time
over wall time; kernels run on one stream, so they do not overlap) and
the kernels that take the most device time.  ``--out`` writes the numbers
as JSON.  On ``--device cpu`` there is no device timeline: only the wall
time is printed.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import serve
from repro_torch.models.api import TConstDecode
from repro_torch.serving.engine import Engine, device_sync


def _device_kernels(prof) -> Dict[str, Dict[str, float]]:
    """{kernel name: {"count", "us"}} of the device-side events."""
    out: Dict[str, Dict[str, float]] = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key] = {"count": e.count, "us": float(us)}
    return out


def profile_calls(fn, n: int, device: torch.device, top: int
                  ) -> Dict[str, Any]:
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    device_sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        device_sync(device)
        wall = time.perf_counter() - t0
    rep: Dict[str, Any] = {"calls": n, "wall_ms": 1e3 * wall / n}
    if device.type != "cuda":
        return rep
    kernels = _device_kernels(prof)
    dev_us = sum(k["us"] for k in kernels.values())
    rep.update({
        "device_ms": dev_us / 1e3 / n,
        "busy_share": dev_us / 1e6 / wall,
        "launches": sum(k["count"] for k in kernels.values()) / n,
        "top": sorted(({"name": name, "launches": k["count"] / n,
                        "ms": k["us"] / 1e3 / n}
                       for name, k in kernels.items()),
                      key=lambda r: -r["ms"])[:top]})
    return rep


def main(argv=None) -> int:
    ap = serve.build_parser()
    ap.description = __doc__.split("\n\n")[0]
    ap.set_defaults(prompt_len=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--out", default="")
    ap.add_argument("--mode", default="",
                    choices=["", "tconst", "tlin", "full"],
                    help="attention mode of a TConst config (default: the "
                         "config's; tlin: the TLinFormer baseline, full: "
                         "the base transformer, both on the same weights)")
    args = serve.parse_args(argv, ap)
    cfg, api, params = serve.load(
        args, **({"attention_mode": args.mode} if args.mode else {}))
    eng = Engine(api, params, max_len=args.prompt_len + args.steps + 64,
                 layout=serve.layout_spec(args, full_pool=True))
    dec, params, dev = eng.decode, eng.params, eng.device
    rng = np.random.RandomState(args.seed + 1)
    prompts = rng.randint(0, cfg.vocab_size,
                          size=(args.batch, args.prompt_len))
    _, state = dec.prefill(params, {"tokens": prompts}, eng.max_len)
    token = torch.zeros((args.batch,), dtype=torch.int32, device=dev)
    rows = np.ones((args.batch,), bool)

    def hit():
        logits, _ = dec.raw_step(params, state, token)
        token.copy_(logits.argmax(dim=-1).to(torch.int32))

    resyncs = isinstance(dec, TConstDecode)     # a periodic resync
    if resyncs:
        hist0 = state.bookkeeping["hist_len"].clone()

    def miss():
        # the fold of a full window onto the prefilled history: the same
        # ids and lengths each time (a resync advances hist_len by W_og)
        state.host["gen_len"][:] = cfg.tconst.w_og
        state.bookkeeping["gen_len"].fill_(cfg.tconst.w_og)
        state.bookkeeping["hist_len"].copy_(hist0)
        dec.sync_rows(params, state, rows)

    def admit():
        dec.prefill_into_slot(params, state, 0, prompts[0])

    if resyncs:
        miss()                               # warm up (kernel build, ...)
    admit()
    for _ in range(3):
        hit()
    report = {"arch": cfg.name, "mode": cfg.attention_mode,
              "layout": args.layout, "dtype": cfg.dtype, "device": str(dev),
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu", "batch": args.batch,
              "prompt_len": args.prompt_len, "max_len": eng.max_len,
              "hit": profile_calls(hit, args.steps, dev, args.top)}
    if resyncs:
        report["resync"] = profile_calls(miss, 3, dev, args.top)
    report["admit"] = profile_calls(admit, 3, dev, args.top)
    for what in ("hit", "resync", "admit"):
        if what not in report:
            continue
        r = report[what]
        line = f"[profile] {what}: wall {r['wall_ms']:.3f} ms/call"
        if "device_ms" in r:
            line += (f", device kernels {r['device_ms']:.3f} ms/call "
                     f"({r['launches']:.0f} launches), busy share "
                     f"{r['busy_share']:.3f}")
        print(line)
        for k in r.get("top", []):
            print(f"[profile]   {k['ms']:.4f} ms  x{k['launches']:.1f}  "
                  f"{k['name'][:90]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
