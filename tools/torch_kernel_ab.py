#!/usr/bin/env python3
"""Time the port's K1, K2, K3, K4 and K2-backward kernels of two source trees
on one GPU, in turns (A B B A), at the cases of this checkout's
``chip_smoke.py``.

    python tools/torch_kernel_ab.py --parent DIR [--out FILE]

``DIR`` is a checkout of an earlier commit (for example unpacked with
``git archive``).  Each turn is a child process that puts one tree's
``src`` first on ``sys.path``, builds that tree's kernels and runs
``chip_smoke.k1_rows``, ``k3_rows``, ``k2_rows`` and ``k2_bwd_rows``
(every case in bf16 and f32, each checked against the tree's plain
version; the backward through ``flash_attention_bwd_cuda``, the wrapper
both trees have since it was written) -- so both trees see the same cases
and the same seeded inputs.  A K1 case that a tree's wrapper refuses (an
earlier K1 kept its scores in shared memory, so it took no more than
~57.9k slots) is printed as refused.  K4 is timed
through ``kernels.ssd_scan.ssd_scan``, the wrapper both trees have with
one signature, at mamba2-130m's admission shapes (batch 4 x 1024 tokens,
one 605-token prompt; f32 and bf16 inputs, made from one seed), each tree
given the chunk its own mixer passes (``ssm_chunk``; a tree without
``jax_chunk`` halved it until it divides L, as JAX does: chunk 1 at 605).
Prints a table of the kernels' device ms per case (each tree's two turns)
beside the SDPA yardstick, and with ``--out`` writes every row as JSON.
Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TAG = "AB_ROWS "


def child(src: str) -> int:
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch
    import chip_smoke as CS
    from repro_torch.config import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    check = Path(_build.__file__).resolve()
    if not str(check).startswith(str(Path(src).resolve())):
        raise RuntimeError(f"imported {check}, not the tree under {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["decode_attention", "flash_attention",
                  "flash_attention_bwd", "paged_decode_attention",
                  "ssd_scan"])
    cfg = get_config("tconst-41m")
    dev = torch.device("cuda")
    max_len = serve.sessions_max_len(serve.parse_args(CS.SESSIONS_ARGS))
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    rows = []
    for dname in ("bfloat16", "float32"):
        for case in CS.k1_cases(torch, cfg, dev, max_len):
            try:
                CS.k1_rows(torch, rows, cfg, dev, randn, gen, dname, max_len,
                           cases=[case], int8_cases=[])
            except ValueError as e:     # the tree's wrapper refuses it
                rows.append({"kernel": CS.K1, "case": case[0],
                             "dtype": dname, "ms": None, "library_ms": None,
                             "refused": str(e)})
        CS.k1_rows(torch, rows, cfg, dev, randn, gen, dname, max_len,
                   cases=[])
        CS.k3_rows(torch, rows, cfg, dev, randn, gen, dname, max_len)
        CS.k2_rows(torch, rows, cfg, dev, randn, dname, max_len)
        k4_rows(torch, CS, rows, dev, dname)
        CS.k2_bwd_rows(torch, rows, cfg, dev, randn, dname)
    print(TAG + json.dumps(rows), flush=True)
    return 0


def k4_rows(torch, CS, rows, dev, dname: str) -> None:
    """K4 through the tree's ``ssd_scan`` wrapper at the chunk the tree's
    mixer passes."""
    from repro_torch.config import get_config
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.layers.ssm import ssm_dims
    cfg = get_config(CS.SSM)
    dims = ssm_dims(cfg)
    H, P, N = dims.n_heads, dims.head_dim, dims.n_state
    dtype = getattr(torch, dname)
    for label, B, L in (("q64_b4", 4, 1024), ("l605", 1, 605)):
        gen = torch.Generator(device=dev).manual_seed(L)
        xbc = torch.randn((B, L, H * P + 2 * N), generator=gen,
                          device=dev).to(dtype)
        x = xbc[..., :H * P].reshape(B, L, H, P)
        b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dt = torch.nn.functional.softplus(
            torch.randn((B, L, H), generator=gen, device=dev) - 4.0)
        a = -torch.arange(1, H + 1, device=dev, dtype=torch.float32)
        chunk = cfg.ssm_chunk
        if not hasattr(SS, "jax_chunk"):
            while L % chunk:
                chunk //= 2
        y, f = SS.ssd_scan(x, dt, a, b, c, chunk)
        torch.cuda.synchronize()
        CS.check(bool(torch.isfinite(y.float()).all()) and
                 bool(torch.isfinite(f).all()), f"K4 {label}: non-finite")
        rows.append({"kernel": "ssd_scan (K4, both)", "case": label,
                     "dtype": dname, "chunk": chunk,
                     "ms": CS.time_ms(lambda: SS.ssd_scan(x, dt, a, b, c,
                                                          chunk)),
                     "library_ms": None})
        del xbc, x, b, c, dt, y, f
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the earlier checkout (A)")
    ap.add_argument("--out", default="")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child)
    trees = {"A": str(Path(args.parent).resolve() / "src"),
             "B": str(ROOT / "src")}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    turns = []
    for who in "ABBA":
        res = subprocess.run([sys.executable, __file__, "--parent",
                              args.parent, "--child", trees[who]],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"turn {who} failed (exit {res.returncode})")
        line = [x for x in res.stdout.splitlines() if x.startswith(TAG)][-1]
        turns.append((who, json.loads(line[len(TAG):])))
    print(card)
    print(f"{'kernel':28s} {'case':17s} {'dtype':8s} {'A ms':>17s} "
          f"{'B ms':>17s} {'library ms':>10s}")
    def ms(x):
        return "refused" if x is None else f"{x:.4f}"

    for i, r in enumerate(turns[1][1]):     # a B turn: never refused
        a = [t[1][i]["ms"] for t in turns if t[0] == "A"]
        b = [t[1][i]["ms"] for t in turns if t[0] == "B"]
        lib = r["library_ms"]
        print(f"{r['kernel']:28s} {r['case']:17s} {r['dtype']:8s} "
              f"{ms(a[0]):>8s} {ms(a[1]):>8s} {ms(b[0]):>8s} {ms(b[1]):>8s} "
              f"{'' if lib is None else f'{lib:10.4f}'}")
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"card": card, "turns": [{"tree": w, "rows": rows}
                                     for w, rows in turns]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
