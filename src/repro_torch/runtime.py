"""Device choice and kernel launch counters.

Entry points run on ``cuda`` unless the caller asks for the CPU.  There
is deliberately no switch that sends CUDA tensors to the plain PyTorch
versions: on a CUDA tensor a kernel wrapper launches its hand-written
kernel or raises.  A plain version runs only because the tensor it was
given lies on the CPU.

Every kernel has a :class:`LaunchCounter`: ``kernel`` counts launches of
the CUDA kernel (incremented by the wrapper right after the launch) and
``plain`` counts calls of its plain version.  ``chip_smoke.py`` resets
them before it drives the main path and reads them after, to show the
path really went through the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``.  Asking for CUDA on a machine without a
    visible GPU raises; nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (CLI: --device "
            "cpu) to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev


@dataclasses.dataclass
class LaunchCounter:
    name: str
    kernel: int = 0     # launches of the hand-written CUDA kernel
    plain: int = 0      # calls of the plain PyTorch version (CPU tensors)

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0


COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    """The (process-wide) counter of kernel ``name``."""
    if name not in COUNTERS:
        COUNTERS[name] = LaunchCounter(name)
    return COUNTERS[name]


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def read_counters() -> Dict[str, Dict[str, int]]:
    return {n: {"kernel": c.kernel, "plain": c.plain}
            for n, c in sorted(COUNTERS.items())}
