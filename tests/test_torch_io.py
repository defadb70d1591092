"""Trajectory and checkpoint IO of the port against the JAX package: a TUM
file round trip, a checkpoint crossing both ways with every field equal,
and localization mode started from a checkpoint path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu import config as jcfg
from multi_orbslam3_tpu.dataio import checkpoint as jckpt
from multi_orbslam3_tpu.dataio import tum as jtum
from multi_orbslam3_tpu.geometry import so3 as jso3
from multi_orbslam3_tpu.map import mapstate as jms
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.bow import vocabulary as tvoc
from multi_orbslam3_tpu_torch.dataio import checkpoint as tckpt
from multi_orbslam3_tpu_torch.dataio import synthetic
from multi_orbslam3_tpu_torch.dataio import tum as ttum
from multi_orbslam3_tpu_torch.geometry import so3 as tso3
from multi_orbslam3_tpu_torch.pipeline import MonoSlam, TrackState

# several test processes share the machine's cores; torch's intra-op pool
# spinning on all of them makes the many small ops here wait on each other
torch.set_num_threads(2)

CT = tcfg.small_synthetic()


def _trajectory(seed=0, n=12):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(jso3.exp(jnp.asarray(rng.randn(3) * 0.8, jnp.float32)))
        T[:3, 3] = rng.randn(3) * 3
        out.append((1403636579.76 + 0.05 * i, T))
    return out


def test_quaternions_equal_jax():
    rng = np.random.RandomState(1)
    w = (rng.randn(64, 3) * 1.5).astype(np.float32)
    R = np.array(jso3.exp(jnp.asarray(w)))
    qj = np.asarray(jso3.to_quaternion(jnp.asarray(R)))
    qt = tso3.to_quaternion(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(qt, qj, atol=1e-6)
    np.testing.assert_allclose(tso3.from_quaternion(torch.from_numpy(np.array(qj))).numpy(),
                               np.asarray(jso3.from_quaternion(jnp.asarray(qj))),
                               atol=1e-6)


@pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("torch", "jax"),
                                           ("jax", "torch")])
def test_tum_round_trip(tmp_path, writer, reader):
    """Poses come back within 1e-5 (7 decimals on disk), timestamps within
    1e-6, whichever package wrote the file."""
    traj = _trajectory()
    path = str(tmp_path / "traj.txt")
    (ttum if writer == "torch" else jtum).write_tum(path, traj)
    back = (ttum if reader == "torch" else jtum).read_tum(path)
    assert len(back) == len(traj)
    for (ts0, T0), (ts1, T1) in zip(traj, back):
        assert abs(ts0 - ts1) < 1e-6
        assert T1.dtype == np.float32 and T1.shape == (4, 4)
        np.testing.assert_allclose(T1, T0, atol=1e-5)


def test_tum_files_of_both_packages_are_the_same_text(tmp_path):
    traj = _trajectory(seed=3)
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    ttum.write_tum(a, traj)
    jtum.write_tum(b, traj)
    rows_a = np.loadtxt(a)
    rows_b = np.loadtxt(b)
    np.testing.assert_allclose(rows_a, rows_b, atol=2e-7)


@pytest.fixture(scope="module")
def port_run():
    """The port's MonoSlam after 30 frames of the small config."""
    seq = synthetic.make_sequence(CT, n_frames=40, n_points=500, seed=7,
                                  trajectory="forward")
    voc = tvoc.default_vocabulary(CT.bow.branching, CT.bow.levels, device="cpu")
    slam = MonoSlam(CT, vocabulary=voc, device="cpu")
    for i in range(30):
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
    slam.keyframe_trajectory()          # adopts what is pending
    assert int(slam.m.n_kf) >= 3
    return seq, voc, slam


def test_checkpoint_written_by_the_port_loads_in_jax(tmp_path, port_run):
    _, _, slam = port_run
    path = str(tmp_path / "map_t.npz")
    tckpt.save_map(path, slam.m, extra={"frame": np.int32(30)})
    mj, extra = jckpt.load_map(path)
    assert int(extra["frame"]) == 30
    want = interop.map_to_numpy(slam.m)
    for f in jms.MapState._fields:
        a = np.asarray(getattr(mj, f))
        assert a.dtype == want[f].dtype, f
        np.testing.assert_array_equal(a, want[f], err_msg=f)
    assert np.asarray(mj.kf_desc).dtype == np.uint32


def test_checkpoint_written_by_jax_loads_in_the_port(tmp_path, port_run):
    """The JAX package saves the (carried) map; the port loads every field
    equal, with descriptors as int32 bit patterns; a checkpoint from before
    the stereo, camera and redirect fields gets their defaults."""
    _, _, slam = port_run
    want = interop.map_to_numpy(slam.m)
    mj = jms.MapState(**{f: jnp.asarray(want[f]) for f in jms.MapState._fields})
    path = str(tmp_path / "map_j.npz")
    jckpt.save_map(path, mj, extra={"note": np.float32(1.5)})
    mt, extra = tckpt.load_map(path, device="cpu")
    assert float(extra["note"]) == 1.5
    assert mt.kf_desc.dtype == torch.int32 and mt.mp_desc.dtype == torch.int32
    got = interop.map_to_numpy(mt)
    for f in jms.MapState._fields:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    with np.load(path) as z:
        old = {k: z[k] for k in z.files
               if k not in ("map.kf_ur", "map.kf_cam", "map.mp_redirect")}
    old_path = str(tmp_path / "map_old.npz")
    np.savez_compressed(old_path, **old)
    mo = tckpt.load_map(old_path, device="cpu")[0]
    mo_j = jckpt.load_map(old_path)[0]
    for f in ("kf_ur", "kf_cam", "mp_redirect"):
        np.testing.assert_array_equal(getattr(mo, f).numpy(),
                                      np.asarray(getattr(mo_j, f)), err_msg=f)


def test_localization_mode_from_a_checkpoint_path(tmp_path, port_run):
    """A fresh system loads the saved map, starts LOST, relocalizes on the
    replayed frames and never mutates the map."""
    seq, voc, slam = port_run
    path = str(tmp_path / "map.npz")
    tckpt.save_map(path, slam.m)
    fresh = MonoSlam(CT, vocabulary=voc, device="cpu")
    fresh.activate_localization_mode(path)
    assert fresh.localization_only and fresh.state == TrackState.LOST
    assert int(fresh.m.n_kf) == int(slam.m.n_kf)
    before = interop.map_to_numpy(fresh.m)
    for i in range(20, 30):
        fresh.process_frame(seq.images[i], float(seq.timestamps[i]))
    assert fresh.stats.get("relocalizations", 0) >= 1
    assert fresh.state == TrackState.OK
    after = interop.map_to_numpy(fresh.m)
    for f in ("kf_pose", "mp_pos", "kf_mp", "n_kf", "n_mp"):
        np.testing.assert_array_equal(after[f], before[f], err_msg=f)
    T = fresh.trajectory[-1][1]
    assert np.abs(T - slam.trajectory[29][1]).max() < 0.05
