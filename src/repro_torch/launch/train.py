"""Training launcher of the port (port of ``src/repro/launch/train.py``).

Runs on ``cuda`` unless ``--device cpu`` is given (no GPU and no
``--device cpu``: it raises).  On CUDA every attention's forward and
backward run K2's kernels; on the CPU their plain versions.  The argv is
the JAX launcher's plus ``--device`` and ``--mode`` (the attention-mode
override of JAX's ``examples/train_lm.py``: ``tconst``, ``tlin``, or
``full`` for the paper's base transformer on the same weights)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch tconst-41m \\
      --reduced --steps 3 --batch 2 --seq 16 --log-every 1 --device cpu

Without ``--reduced`` it trains ``tconst-41m`` at full width on the card.
Prints loss, grad norm and tok/s lines as the JAX launcher does; with
``--ckpt-dir`` it writes the final train state in the JAX package's
msgpack format.  The MoE and SSM families raise (ROADMAP Queue 1 items
10b, 10c); the VLM and enc-dec families are not ported (item 9).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.config import get_config, reduced
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.models.api import build_model
from repro_torch.training.checkpoint import save_train_state
from repro_torch.training.optim import (AdamWConfig, init_opt_state,
                                        tree_leaves)
from repro_torch.training.schedules import warmup_cosine, wsd
from repro_torch.training.train_step import make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tconst-41m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--schedule", choices=["cosine", "wsd"], default="cosine")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (CPU-scale) variant")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--data", default="synthetic", choices=["synthetic",
                                                            "text"])
    ap.add_argument("--text-path", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--mode", default="", choices=["", "tconst", "tlin",
                                                   "full"],
                    help="attention mode override (default: the config's)")
    return ap


def load(args) -> tuple:
    """(cfg, api, params) for parsed ``args``: the port's seeded init, in
    the JAX tree layout the train step takes."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, vocab_size=args.vocab)
    if args.mode:
        cfg = cfg.replace(attention_mode=args.mode)
    if cfg.arch_type in ("vlm", "audio") or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.arch_type} family is not ported "
            f"yet: ROADMAP Queue 1 item 9 (enc-dec, hybrid and VLM)")
    if cfg.attention_mode in ("tconst", "tlin") and \
            args.seq % cfg.tconst.w_og:
        raise ValueError(f"--seq must be a multiple of W_og="
                         f"{cfg.tconst.w_og}")
    api = build_model(cfg, device=args.device)
    return cfg, api, bridge.stack_params(api.init(args.seed))


def train(cfg, api, params, args,
          data: Optional[Iterable[Dict[str, np.ndarray]]] = None,
          log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Run ``args.steps`` train steps from ``params`` (JAX tree layout) on
    ``data`` (default: the synthetic / text pipeline of ``args``).  Each
    step's wall time ends at its loss read (a device sync).  Returns
    params, opt, losses, grad_norms, step_s and tok_s."""
    opt_cfg = AdamWConfig(lr=args.lr)
    opt = init_opt_state(params, opt_cfg)
    sched = (wsd(args.steps // 20, int(args.steps * 0.85),
                 args.steps // 10) if args.schedule == "wsd"
             else warmup_cosine(args.steps // 20, args.steps))
    step_fn = make_train_step(api, opt_cfg, sched, n_micro=args.n_micro)
    if data is None:
        data = batches(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, batch_size=args.batch,
                                  seed=args.seed, kind=args.data,
                                  text_path=args.text_path),
                       steps=args.steps)
    dev = api.device
    losses, gnorms, step_s = [], [], []
    t0 = time.time()
    for i, b in enumerate(data):
        if i >= args.steps:
            break
        batch = {"tokens": torch.from_numpy(
            np.ascontiguousarray(b["tokens"][:, :args.seq])).to(dev)}
        ts = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - ts)
        gnorms.append(float(m["grad_norm"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            toks = args.batch * args.seq * (i + 1)
            log(f"[train] step {i:5d} loss={losses[-1]:.4f} "
                f"gnorm={gnorms[-1]:.3f} "
                f"tok/s={toks / (time.time() - t0):9.0f}")
    tok_s = args.batch * args.seq * len(losses) / (time.time() - t0)
    return {"params": params, "opt": opt, "losses": losses,
            "grad_norms": gnorms, "step_s": step_s, "tok_s": tok_s}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg, api, params = load(args)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] arch={cfg.name} params={n_params / 1e6:.2f}M "
          f"mode={cfg.attention_mode} device={api.device}")
    out = train(cfg, api, params, args)
    if args.ckpt_dir:
        path = save_train_state(out["params"], out["opt"], args.steps,
                                args.ckpt_dir)
        print(f"[train] checkpoint -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
