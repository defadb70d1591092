"""The PyTorch port and chip_smoke.py run without JAX and without the JAX
package (a GPU machine need have neither): the port keeps its own copies
of the JAX package's numpy-only modules and of the bundled vocabularies,
and these tests hold the copies equal to their originals. The subprocess
checks run in a fresh interpreter with no CUDA device visible, so they say
the same on a machine with a card."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "multi_orbslam3_tpu_torch"

_IMPORT_EVERY_MODULE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None                  # any import of jax raises,
sys.modules["multi_orbslam3_tpu"] = None   # and any of the JAX package
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
    """With both `jax` and `multi_orbslam3_tpu` blocked."""
    r = _python("-c", _IMPORT_EVERY_MODULE)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 25


def test_no_source_of_the_port_imports_the_jax_package():
    """No import line of the port or of chip_smoke.py names jax or
    multi_orbslam3_tpu (without _torch)."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|multi_orbslam3_tpu)(\.|\s|$)")
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 25
    hits = [f"{f.relative_to(REPO)}:{i}: {line.strip()}"
            for f in files for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits


@pytest.mark.parametrize("preset", [None, "small_synthetic", "synthetic_mono"])
def test_the_ports_config_equals_the_jax_packages(preset):
    """The port's copy of config.py cannot drift unnoticed: the default
    SystemConfig and the presets the tests and chip_smoke.py use are equal
    field by field; the tests build each package's config on its own."""
    from multi_orbslam3_tpu import config as jcfg
    from multi_orbslam3_tpu_torch import config as tcfg
    make = (lambda m: m.SystemConfig()) if preset is None else (
        lambda m: getattr(m, preset)())
    cj, ct = make(jcfg), make(tcfg)
    assert type(cj) is not type(ct)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)


@pytest.mark.parametrize("name", ["orbvoc_synthetic_k10_L4.npz",
                                  "orbvoc_synthetic_k10_L5.npz"])
def test_the_bundled_vocabularies_are_byte_identical_copies(name):
    a = (REPO / "multi_orbslam3_tpu" / "bow" / name).read_bytes()
    b = (PORT / "bow" / name).read_bytes()
    assert a == b
    from multi_orbslam3_tpu_torch.bow import vocabulary as tvoc
    depth = int(name[-5])
    assert Path(tvoc.bundled_path(10, depth)) == PORT / "bow" / name


def test_the_ports_synthetic_and_ate_copies_equal_the_jax_packages():
    """Same seed, same sequence, bit for bit; the same ATE on it."""
    from multi_orbslam3_tpu import config as jcfg
    from multi_orbslam3_tpu.dataio import synthetic as jsyn
    from multi_orbslam3_tpu.eval import ate as jate
    from multi_orbslam3_tpu_torch import config as tcfg
    from multi_orbslam3_tpu_torch.dataio import synthetic as tsyn
    from multi_orbslam3_tpu_torch.eval import ate as tate
    kw = dict(n_frames=3, n_points=200, seed=7, trajectory="forward")
    sj = jsyn.make_sequence(jcfg.small_synthetic(), **kw)
    st = tsyn.make_sequence(tcfg.small_synthetic(), **kw)
    np.testing.assert_array_equal(st.images, sj.images)
    np.testing.assert_array_equal(st.T_cw, sj.T_cw)
    np.testing.assert_array_equal(st.timestamps, sj.timestamps)
    est = sj.T_cw.copy()
    est[:, :3, 3] += np.random.RandomState(0).normal(0, 0.01, (3, 3))
    assert tate.ate_rmse(tate.camera_centers(est), tate.camera_centers(st.T_cw)) == \
        jate.ate_rmse(jate.camera_centers(est), jate.camera_centers(sj.T_cw))


_MONOSLAM_WITHOUT_A_DEVICE = """
import torch
from multi_orbslam3_tpu_torch import config
from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam
assert not torch.cuda.is_available()
try:
    MonoSlam(config.small_synthetic(), enable_loop_closing=False)
except RuntimeError as e:
    assert "no CUDA device" in str(e), e
    print("raised")
slam = MonoSlam(config.small_synthetic(), enable_loop_closing=False, device="cpu")
print(slam.device.type)
"""


def test_monoslam_without_a_device_raises_where_there_is_no_card():
    """MonoSlam(cfg) runs on the card; without one it raises and does not
    carry on on the CPU by itself. device="cpu" is the caller's to ask."""
    r = _python("-c", _MONOSLAM_WITHOUT_A_DEVICE)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["raised", "cpu"]


def test_chip_smoke_without_a_gpu_exits_nonzero_and_prints_no_result():
    """chip_smoke.py blocks jax itself; without a card it stops at its
    first CUDA call with an error and never prints the ok line."""
    r = _python("chip_smoke.py")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert '"ok"' not in r.stdout
