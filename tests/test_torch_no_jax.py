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
print(" ".join(names))
"""

# the harness: entry scripts, bench, dataset ingest, benchmarks, viewer
HARNESS_MODULES = (
    "apps.run_slam", "apps.run_mono", "apps.run_collab_sim", "apps.run_server",
    "apps.run_client", "apps.train_vocabulary", "bench", "dataio.euroc",
    "dataio.mini_asl", "dataio.rectify", "eval.benchmarks", "eval.viewer", "utils.timing")


def _python(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_port_module_imports_with_jax_blocked():
    """With both `jax` and `multi_orbslam3_tpu` blocked."""
    r = _python("-c", _IMPORT_EVERY_MODULE)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    assert len(names) >= 60
    assert {f"multi_orbslam3_tpu_torch.{n}" for n in HARNESS_MODULES} <= names


def test_no_source_of_the_port_imports_the_jax_package():
    """No import line of the port or of chip_smoke.py names jax or
    multi_orbslam3_tpu (without _torch)."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|multi_orbslam3_tpu)(\.|\s|$)")
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 60
    assert {PORT / (n.replace(".", "/") + ".py") for n in HARNESS_MODULES} <= set(files)
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


def _changed_lines(a: str, b: str) -> tuple:
    import difflib
    removed, added = [], []
    for line in difflib.unified_diff(a.splitlines(), b.splitlines(), lineterm="", n=0):
        if line.startswith("-") and not line.startswith("---"):
            removed.append(line[1:])
        elif line.startswith("+") and not line.startswith("+++"):
            added.append(line[1:])
    return removed, added


@pytest.mark.parametrize("name", ["transport.py", "protocol.py", "codec.py"])
def test_the_ports_wire_modules_are_copies(name):
    """transport.py is byte for byte the JAX package's; protocol.py differs
    in its import of the codec only; codec.py only where its native half is
    built (csrc/ -> _build/, keyed by a hash, instead of native/)."""
    a = (REPO / "multi_orbslam3_tpu" / "collab" / name).read_text()
    b = (PORT / "collab" / name).read_text()
    removed, added = _changed_lines(a, b)
    if name == "transport.py":
        assert a == b
    elif name == "protocol.py":
        assert removed == ["from multi_orbslam3_tpu.collab import codec"]
        assert added == ["from multi_orbslam3_tpu_torch.collab import codec"]
    else:
        text = "\n".join(removed + added)
        assert all(("native" in ln or "so" in ln or "src" in ln or "_build" in ln
                    or ln.strip() in ("", "return None",
                                      "if not os.path.exists(src):",
                                      "if not os.path.exists(so):"))
                   for ln in removed), removed
        assert "def _build_path" in text and "libmo3codec_" in text
        assert len(removed) <= 8 and len(added) <= 20, (removed, added)
        # everything from the pack/unpack API down is unchanged
        tail = a[a.index("# pack / unpack"):]
        assert tail == b[b.index("# pack / unpack"):]


def test_the_codec_source_is_a_byte_identical_copy():
    assert (REPO / "native" / "mo3_codec.cpp").read_bytes() == \
        (PORT / "csrc" / "mo3_codec.cpp").read_bytes()


def test_the_ports_codec_builds_its_own_library():
    """Into _build/ next to the package, never native/libmo3codec.so."""
    from multi_orbslam3_tpu_torch.collab import codec
    assert codec.native_available()
    src = str(PORT / "csrc" / "mo3_codec.cpp")
    so = codec._build_path(src)
    assert Path(so).parent == PORT / "_build" and Path(so).exists()
    assert Path(codec._lib._name) == Path(so)


def test_socket_transport_round_trip_of_a_delta():
    """The port's socket transport carries a packed delta both ways."""
    import time
    from multi_orbslam3_tpu_torch.collab import protocol
    from multi_orbslam3_tpu_torch.collab.transport import (SocketTransportClient,
                                                           SocketTransportServer)
    payload = protocol.MapDelta(agent=1, seq=3, erased_kf=np.asarray([5], np.int32)).to_bytes()
    srv = SocketTransportServer()
    cli = SocketTransportClient(agent=1, host="127.0.0.1", port=srv.port)
    try:
        cli.send_up(1, payload)
        for _ in range(200):
            msgs = srv.poll_up(1)
            if msgs:
                break
            time.sleep(0.01)
        assert msgs == [payload]
        assert protocol.MapDelta.from_bytes(msgs[0]).erased_kf.tolist() == [5]
        srv.send_down(1, payload[::-1])
        for _ in range(200):
            msgs = cli.poll_down(1)
            if msgs:
                break
            time.sleep(0.01)
        assert msgs == [payload[::-1]]
    finally:
        cli.close()
        srv.close()


_HELPERS_WITHOUT_A_DEVICE = """
import torch
assert not torch.cuda.is_available()
from multi_orbslam3_tpu_torch import config
from multi_orbslam3_tpu_torch.bow import database, vocabulary
from multi_orbslam3_tpu_torch.collab import CollabClient, CollabServer, InProcessTransport
from multi_orbslam3_tpu_torch.dataio import checkpoint
from multi_orbslam3_tpu_torch.map import mapstate
import numpy as np, tempfile, os
path = os.path.join(tempfile.mkdtemp(), "m.npz")
checkpoint.save_map(path, mapstate.empty_map(2, 4, 8))
c = config.small_synthetic()
calls = {
    "default_vocabulary": lambda d: vocabulary.default_vocabulary(6, 3, device=d),
    "load_vocabulary": lambda d: vocabulary.load_vocabulary(vocabulary.bundled_path(10, 4), device=d),
    "train_vocabulary": lambda d: vocabulary.train_vocabulary(
        np.random.RandomState(0).randint(0, 2 ** 32, (200, 8), dtype=np.uint32), 3, 2, device=d),
    "KeyframeDatabase.empty": lambda d: database.KeyframeDatabase.empty(4, device=d),
    "load_map": lambda d: checkpoint.load_map(path, device=d),
    "CollabClient": lambda d: CollabClient(c, 0, InProcessTransport(), device=d),
    "CollabServer": lambda d: CollabServer(c, InProcessTransport(), 2, device=d),
}
for name, fn in calls.items():
    try:
        fn(None)
        print(name, "ran")
    except RuntimeError as e:
        assert "no CUDA device" in str(e) and name in str(e), e
        print(name, "raised")
    fn("cpu")
cl = CollabClient(c, 0, InProcessTransport(), inertial=True, device="cpu")
assert type(cl.slam).__name__ == "MonoInertialSlam" and cl.slam.device.type == "cpu"
print("inertial client ran")
"""

_HARNESS_WITHOUT_A_DEVICE = """
import contextlib, io, os, sys, tempfile
import torch
assert not torch.cuda.is_available()
torch.set_num_threads(2)
from multi_orbslam3_tpu_torch.apps import (run_client, run_collab_sim, run_mono, run_server,
                                           run_slam, train_vocabulary)
from multi_orbslam3_tpu_torch.collab.transport import SocketTransportServer
from multi_orbslam3_tpu_torch.eval import benchmarks as B
tmp = tempfile.mkdtemp()
srv = SocketTransportServer()

def app(main, *argv):
    def run(d):
        sys.argv = ["app", *argv] + ([] if d is None else ["--device", d])
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            main()
    return run

calls = {
    "bench_mono": lambda d: B.bench_mono(n_frames=1, device=d),
    "bench_stereo": lambda d: B.bench_stereo(n_frames=1, device=d),
    "bench_mono_inertial": lambda d: B.bench_mono_inertial(n_frames=1, device=d),
    "bench_collab": lambda d: B.bench_collab(n_agents=1, n_frames=1, warmup=False, device=d),
    "bench_gba_large": lambda d: B.bench_gba_large(8, 256, 32, 1, 2, device=d),
    "bench_vocab_selectivity": lambda d: B.bench_vocab_selectivity(1, 2, device=d),
    "bench_mini_asl": lambda d: B.bench_mini_asl(n_frames=1, device=d),
    "run_slam": app(run_slam.main, "--out", f"{tmp}/s", "--frames", "1", "--no-loop-closing"),
    "run_mono": app(run_mono.main, "--out", f"{tmp}/m", "--frames", "1", "--no-loop-closing"),
    "run_collab_sim": app(run_collab_sim.main, "--out", f"{tmp}/c", "--agents", "1",
                          "--frames", "1"),
    "run_server": app(run_server.main, "--port", "0", "--out", f"{tmp}/srv", "--duration", "0",
                      "--small"),
    "run_client": app(run_client.main, "--agent", "0", "--server", f"127.0.0.1:{srv.port}",
                      "--out", f"{tmp}/cl", "--frames", "1", "--small"),
    "train_vocabulary": app(train_vocabulary.main, "--worlds", "1", "--frames", "1",
                            "--branching", "2", "--depth", "2", "--out", f"{tmp}/v.npz"),
    # too heavy for the CPU here (the plain K2 at 16384 x 1024), or no
    # dataset: only the default is checked
    "bench_kernels": lambda d: None if d else B.bench_kernels(),
    "bench_euroc": lambda d: None if d else B.bench_euroc(tmp),
}
for name, fn in calls.items():
    try:
        fn(None)
        print(name, "ran")
    except RuntimeError as e:
        assert "no CUDA device" in str(e) and name.replace("run_mono", "run_slam") in str(e), e
        print(name, "raised")
    fn("cpu")
srv.close()
for f in ("s/report.json", "m/report.json", "c/report.json", "srv/server_map.npz",
          "cl/KeyFrameTrajectory.txt", "v.npz"):
    assert os.path.exists(os.path.join(tmp, f)), f
print("outputs written")
"""


def test_helpers_and_collab_entry_points_default_to_the_card():
    """device=None is the CUDA device for the vocabulary, database and
    checkpoint helpers and for CollabClient/CollabServer: without a card
    each raises, and device="cpu" runs. The same holds for the harness:
    every benchmark function (device=None) and every app (no --device)
    raises naming itself, and runs with "cpu" (one frame each)."""
    r = _python("-c", _HELPERS_WITHOUT_A_DEVICE)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[:-1] == [f"{n} raised" for n in (
        "default_vocabulary", "load_vocabulary", "train_vocabulary",
        "KeyframeDatabase.empty", "load_map", "CollabClient", "CollabServer")]
    assert lines[-1] == "inertial client ran"
    r = _python("-c", _HARNESS_WITHOUT_A_DEVICE)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[:-1] == [f"{n} raised" for n in (
        "bench_mono", "bench_stereo", "bench_mono_inertial", "bench_collab", "bench_gba_large",
        "bench_vocab_selectivity", "bench_mini_asl", "run_slam", "run_mono", "run_collab_sim",
        "run_server", "run_client", "train_vocabulary", "bench_kernels", "bench_euroc")]
    assert lines[-1] == "outputs written"


def test_the_ports_padding_module_is_a_byte_identical_copy():
    """utils/padding.py (pow2_len, pad_pow2) is the JAX package's, byte for
    byte, and computes the same buckets."""
    a = (REPO / "multi_orbslam3_tpu" / "utils" / "padding.py").read_bytes()
    assert a == (PORT / "utils" / "padding.py").read_bytes()
    from multi_orbslam3_tpu.utils import padding as jpad
    from multi_orbslam3_tpu_torch.utils import padding as tpad
    for n in (0, 1, 7, 8, 9, 100, 256, 257):
        assert tpad.pow2_len(n, lo=16) == jpad.pow2_len(n, lo=16)
    ids = np.arange(5)
    for x, y in zip(tpad.pad_pow2(ids, ids * 2.0), jpad.pad_pow2(ids, ids * 2.0)):
        np.testing.assert_array_equal(x, y)


_NEW_MODULES_WITH_JAX_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["multi_orbslam3_tpu"] = None
from multi_orbslam3_tpu_torch.eval import gba_scaling
from multi_orbslam3_tpu_torch import dryrun
from multi_orbslam3_tpu_torch.utils import padding
s = gba_scaling.make_server_arena(n_kf=8, n_mp=256, n_feat=32, device="cpu")
print(int(s.m.n_kf), padding.pow2_len(20))
"""


def test_gba_scaling_and_the_dryrun_import_nothing_of_jax():
    r = _python("-c", _NEW_MODULES_WITH_JAX_BLOCKED)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["8", "32"]
