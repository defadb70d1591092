"""The PyTorch port and chip_smoke.py run without JAX (a GPU machine has
none). Each check runs in a fresh interpreter with no CUDA device visible,
so it says the same on a machine with a card."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_IMPORT_EVERY_MODULE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax raises
import multi_orbslam3_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def _python(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_port_module_imports_with_jax_blocked():
    r = _python("-c", _IMPORT_EVERY_MODULE)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20


def test_chip_smoke_without_a_gpu_exits_nonzero_and_prints_no_result():
    """chip_smoke.py blocks jax itself; without a card it stops at its
    first CUDA call with an error and never prints the ok line."""
    r = _python("chip_smoke.py")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert '"ok"' not in r.stdout
