"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by
``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch_kernels/`` at the repository root, named by a hash of
its source, the shared headers and the flags (so an edited source or
header is rebuilt), and loaded with
``ctypes``.  Building happens at first use, never at import; :func:`build`
compiles several sources in parallel, one ``nvcc`` each, and each
``nvcc`` splits its optimisation over the host's cores
(``--split-compile=0``: the six sources built in 20 s instead of 32 on
the H100 machine's 8 cores, the longest, ``flash_attention_bwd.cu``, no
longer alone on one core).  A failed build raises with the compiler's
output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
SOURCES = ("decode_attention", "flash_attention", "flash_attention_bwd",
           "paged_decode_attention", "ssd_scan", "ssd_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}
BUILD_LOG: Dict[str, str] = {}         # compiler output (ptxas -v etc.)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the GPU")
    return found


def _flags(verbose: bool) -> List[str]:
    return list(NVCC_FLAGS) + (["-Xptxas=-v"] if verbose else [])


def target(name: str) -> Path:
    """Library path of ``name``, keyed by its source, the shared headers
    (``csrc/*.cuh``) and the flags (``-v`` only adds compiler output, not
    code, so it is not part of the key)."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None,
          verbose: bool = False) -> Dict[str, float]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together.  Returns {name: seconds} for the sources
    compiled by this call."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *_flags(verbose), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out)
    done: Dict[str, float] = {}
    errors = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = secs
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of kernel library ``name`` (built on first
    use).  Every entry returns the ``cudaError_t`` of its launch."""
    fn = _FUNCS.get(symbol)
    if fn is None:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(target(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[symbol] = fn
    return fn
