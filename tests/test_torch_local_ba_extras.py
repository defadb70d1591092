"""The port's bundle_adjust(grouped=..., structure_only=...), the chunked
covisibility matrix and the viewer's sub-map colouring, against the JAX
package on the CPU, from the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multi_orbslam3_tpu.geometry import camera as jcam
from multi_orbslam3_tpu.geometry import se3 as jse3
from multi_orbslam3_tpu.map import mapstate as jms
from multi_orbslam3_tpu.opt import local_ba as jba
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.eval import viewer
from multi_orbslam3_tpu_torch.geometry import camera as tcam
from multi_orbslam3_tpu_torch.map import mapstate as tms
from multi_orbslam3_tpu_torch.opt import local_ba as tba

torch.set_num_threads(2)

KV = (400.0, 400.0, 320.0, 240.0)
KJ = jcam.PinholeK(*[jnp.float32(v) for v in KV])
KT = tcam.PinholeK(*[torch.tensor(v) for v in KV])


def opt_window(n_kf=4, n_pts=100, noise_pose=0.02, noise_pt=0.05, seed=4):
    """tests/test_opt.py::TestBundleAdjust._window as numpy arrays: (poses
    true, points true, poses0, points0, fixed, kf, pt, uv)."""
    rng = np.random.RandomState(seed)
    srng = np.random.RandomState(seed)
    pts = np.stack([srng.uniform(-2, 2, n_pts), srng.uniform(-1.5, 1.5, n_pts),
                    srng.uniform(3.0, 7.0, n_pts)], axis=1).astype(np.float32)
    poses = np.stack([np.asarray(jse3.exp(jnp.asarray([0.0, 0.01 * i, 0.0, 0.3 * i, 0.0, 0.0])))
                      for i in range(n_kf)])
    kf = np.repeat(np.arange(n_kf), n_pts).astype(np.int32)
    pt = np.tile(np.arange(n_pts), n_kf).astype(np.int32)
    uv = np.asarray(jcam.project(KJ, jse3.apply(jnp.asarray(poses[kf]), jnp.asarray(pts[pt]))))
    poses0 = [poses[0]]
    for i in range(1, n_kf):
        noise = jnp.asarray(rng.randn(6) * noise_pose, jnp.float32)
        poses0.append(np.asarray(jse3.retract(jnp.asarray(poses[i]), noise)))
    pts0 = (pts + np.asarray(rng.randn(n_pts, 3) * noise_pt, np.float32)).astype(np.float32)
    return poses, pts, np.stack(poses0), pts0, np.arange(n_kf) == 0, kf, pt, uv


def solve_both(poses0, fixed, pts0, kf, pt, uv, **kw):
    ones = np.ones(kf.shape[0], np.float32)
    rj = jba.bundle_adjust(jnp.asarray(poses0), jnp.asarray(fixed), jnp.asarray(pts0),
                           jba.BAObservations(jnp.asarray(kf), jnp.asarray(pt), jnp.asarray(uv),
                                              jnp.asarray(ones), jnp.ones(kf.shape[0], bool)),
                           KJ, **kw)
    t = lambda a: torch.from_numpy(np.array(a))
    rt = tba.bundle_adjust(t(poses0), t(fixed), t(pts0),
                           tba.BAObservations(t(kf).long(), t(pt).long(), t(uv), t(ones),
                                              torch.ones(kf.shape[0], dtype=torch.bool)),
                           KT, **kw)
    return rj, rt


def test_grouped_bundle_adjust_matches_jax_and_scatter():
    """tests/test_opt.py::test_grouped_assembly_matches_scatter's window and
    tolerances: the port's grouped solve against JAX's grouped solve and
    against the port's own scatter solve."""
    _, _, poses0, pts0, fixed, kf, pt, uv = opt_window(seed=4)
    rj, rt = solve_both(poses0, fixed, pts0, kf, pt, uv, iters=8, grouped=True)
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses), atol=1e-4)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), atol=1e-3)
    _, rs = solve_both(poses0, fixed, pts0, kf, pt, uv, iters=8)
    np.testing.assert_allclose(rt.poses.numpy(), rs.poses.numpy(), atol=1e-4)
    np.testing.assert_allclose(rt.points.numpy(), rs.points.numpy(), atol=1e-3)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))


def test_grouped_assembly_in_blocks_with_a_remainder(monkeypatch):
    """The one-hot blocks of the grouped assembly split the window into
    chunks of keyframes (here 3 + 1) and still equal the index_add
    assembly's result."""
    _, _, poses0, pts0, fixed, kf, pt, uv = opt_window(seed=4)
    _, whole = solve_both(poses0, fixed, pts0, kf, pt, uv, iters=3, grouped=True)
    monkeypatch.setattr(tba, "_ONEHOT_ELEMS", 3 * 100 * 100)
    _, split = solve_both(poses0, fixed, pts0, kf, pt, uv, iters=3, grouped=True)
    _, scatter = solve_both(poses0, fixed, pts0, kf, pt, uv, iters=3)
    np.testing.assert_allclose(split.poses.numpy(), whole.poses.numpy(), atol=1e-6)
    np.testing.assert_allclose(split.points.numpy(), scatter.points.numpy(), atol=1e-4)


def test_structure_only_matches_jax():
    """tests/test_opt.py::test_structure_only's window: true poses, all
    fixed, perturbed landmarks; the points agree with JAX to 1e-4 and the
    poses come back bit for bit."""
    poses, pts, _, pts0, _, kf, pt, uv = opt_window(noise_pose=0.0)
    fixed = np.ones(4, bool)
    rj, rt = solve_both(poses, fixed, pts0, kf, pt, uv, iters=10, structure_only=True)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), atol=1e-4)
    np.testing.assert_array_equal(rt.poses.numpy(), poses)
    assert np.abs(rt.points.numpy() - pts).max() < 1e-2


def covis_map(seed=3, K=10, P=260, N=40):
    """The same populated map in both packages (keyframe 7 invalid, a tenth
    of the landmarks invalid, repeated landmarks within rows)."""
    rng = np.random.RandomState(seed)
    d = {f: np.array(v) for f, v in
         ((f, getattr(jms.empty_map(K, P, N), f)) for f in jms.MapState._fields)}
    d["kf_valid"][:] = True
    d["kf_valid"][7] = False
    d["kf_feat_valid"][:] = rng.rand(K, N) < 0.9
    d["kf_mp"][:] = np.where(rng.rand(K, N) < 0.7, rng.randint(0, P, (K, N)), -1)
    d["mp_valid"][:] = rng.rand(P) < 0.9
    d["n_kf"], d["n_mp"] = np.int32(K), np.int32(P)
    return jms.MapState(**{f: jnp.asarray(v) for f, v in d.items()}), interop.map_from_numpy(d)


@pytest.mark.parametrize("chunk", [64, 100, 8192])
def test_chunked_covisibility_matrix_matches_jax(chunk):
    """Each chunk size (64 and 100 leave a remainder of the 260 landmarks;
    8,192 is the default, one chunk) gives the JAX package's counts."""
    mj, mt = covis_map()
    want = np.asarray(jms.covisibility_matrix(mj, chunk))
    got = tms.covisibility_matrix(mt, chunk).numpy()
    assert got.dtype == np.int32 and want.shape == got.shape == (10, 10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jms.covisibility_matrix(mj)))
    assert got[7].sum() == 0 and got.sum() > 0


def test_plot_map_colours_keyframes_by_sub_map(tmp_path):
    """With kf_map, keyframes of one agent in two sub-maps take two
    colours; without it, the one agent colour."""
    m = tms.empty_map(8, 16, 4, "cpu")
    poses = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    poses[:, 0, 3] = -np.arange(8, dtype=np.float32)
    m = m._replace(kf_pose=torch.from_numpy(poses), kf_valid=torch.ones(8, dtype=torch.bool))
    kf_map = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.int32)

    def colours(path, **kw):
        viewer.plot_map(m, str(path), **kw)
        with Image.open(str(path)) as im:
            return {tuple(c) for c in np.unique(np.asarray(im).reshape(-1, 3), axis=0)}

    by_map = colours(tmp_path / "maps.png", kf_map=kf_map)
    by_agent = colours(tmp_path / "agent.png")
    assert {(31, 119, 180), (255, 127, 14)} <= by_map
    assert (31, 119, 180) in by_agent and (255, 127, 14) not in by_agent
