"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke`` pulls in neither JAX nor any module of the JAX package nor
``msgpack`` (the GPU machine has none: the checkpoints carry their own
codec), and
``chip_smoke.py`` fails (printing no result) without a GPU or outside a
checkout."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, {root!r})
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_no_jax_and_no_jax_package():
    res = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         env=_env(), cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_fails_without_gpu_or_checkout(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd, script in ((tmp_path, alone), (ROOT, ROOT / "chip_smoke.py")):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        if cwd == ROOT and res.returncode == 0:
            continue                      # a GPU is visible: the real run
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
