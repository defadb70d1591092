"""Geometry, optimisers and the two-view initializer of the PyTorch port
against the JAX package, on the CPU, from the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.geometry import camera as jcam
from multi_orbslam3_tpu.geometry import se3 as jse3
from multi_orbslam3_tpu.geometry import so3 as jso3
from multi_orbslam3_tpu.geometry import triangulation as jtri
from multi_orbslam3_tpu.opt import local_ba as jba
from multi_orbslam3_tpu.opt import pose_opt as jpo
from multi_orbslam3_tpu.pipeline import initializer as jinit
from multi_orbslam3_tpu_torch.geometry import camera as tcam
from multi_orbslam3_tpu_torch.geometry import se3 as tse3
from multi_orbslam3_tpu_torch.geometry import so3 as tso3
from multi_orbslam3_tpu_torch.geometry import triangulation as ttri
from multi_orbslam3_tpu_torch.opt import local_ba as tba
from multi_orbslam3_tpu_torch.opt import pose_opt as tpo
from multi_orbslam3_tpu_torch.pipeline import initializer as tinit

KV = (400.0, 400.0, 320.0, 240.0)
KJ = jcam.PinholeK(*[jnp.float32(v) for v in KV])
KT = tcam.PinholeK(*[torch.tensor(v) for v in KV])
TOL = dict(atol=1e-5, rtol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def rotvecs(seed, n=64):
    """Rotation vectors from tiny (Taylor branch) to near pi."""
    rng = np.random.RandomState(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = np.concatenate([[0.0, 1e-6, 5e-5], rng.uniform(1e-3, 3.0, n - 4),
                            [np.pi - 1e-3]])
    return (axis * angle[:, None]).astype(np.float32)


def scene(n=120, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                     rng.uniform(3.0, 7.0, n)], axis=1).astype(np.float32)


def test_so3_matches_jax():
    """Within 1e-5: hat/vee, exp, right Jacobian, re-orthogonalisation;
    within 1e-4: log and the inverse right Jacobian (float32 atan2 and
    cot terms near pi)."""
    w = rotvecs(0)
    close(tso3.hat(t(w)), jso3.hat(jnp.asarray(w)))
    R = jso3.exp(jnp.asarray(w))
    close(tso3.exp(t(w)), R)
    close(tso3.vee(t(R)), jso3.vee(R))
    close(tso3.log(t(R)), jso3.log(R), atol=1e-4, rtol=1e-4)
    close(tso3.right_jacobian(t(w)), jso3.right_jacobian(jnp.asarray(w)))
    close(tso3.right_jacobian_inv(t(w[:-1])), jso3.right_jacobian_inv(jnp.asarray(w[:-1])),
          atol=1e-4, rtol=1e-4)
    noisy = np.asarray(R) + np.random.RandomState(1).normal(0, 1e-3, R.shape).astype(np.float32)
    close(tso3.normalize_rotation(t(noisy)), jso3.normalize_rotation(jnp.asarray(noisy)))


def test_se3_matches_jax():
    """Within 1e-5: exp, inverse, apply, retract, normalize; log within
    1e-4 (it goes through so3.log)."""
    rng = np.random.RandomState(2)
    xi = np.concatenate([rotvecs(3, 32)[:-1], rng.normal(0, 1, (31, 3))],
                        1).astype(np.float32)
    T = jse3.exp(jnp.asarray(xi))
    close(tse3.exp(t(xi)), T)
    close(tse3.log(t(T)), jse3.log(T), atol=1e-4, rtol=1e-4)
    close(tse3.inverse(t(T)), jse3.inverse(T))
    p = rng.normal(0, 3, (31, 3)).astype(np.float32)
    close(tse3.apply(t(T), t(p)), jse3.apply(T, jnp.asarray(p)))
    close(tse3.retract(t(T), t(xi * 0.1)), jse3.retract(T, jnp.asarray(xi * 0.1)))
    close(tse3.normalize(t(T)), jse3.normalize(T))


def test_camera_models_match_jax():
    """Within 1e-5 relative: pinhole Jacobian/unproject, radtan distort,
    KB8 unproject; pixels (project, undistort, KB8 project) within 1e-3
    absolute; the KB8 Jacobian within 1e-4 absolute."""
    p = scene(50, 4)
    close(tcam.project(KT, t(p)), jcam.project(KJ, jnp.asarray(p)), atol=1e-3)
    close(tcam.project_jacobian(KT, t(p)), jcam.project_jacobian(KJ, jnp.asarray(p)))
    uv = np.asarray(jcam.project(KJ, jnp.asarray(p)))
    close(tcam.unproject(KT, t(uv)), jcam.unproject(KJ, jnp.asarray(uv)))
    np.testing.assert_array_equal(
        tcam.in_image(t(uv), 640, 480, 10.0).numpy(),
        np.asarray(jcam.in_image(jnp.asarray(uv), 640, 480, 10.0)))
    dist = np.array([-0.28, 0.07, 2e-4, 1.8e-5, 0.0], np.float32)
    close(tcam.undistort_pixels(KT, t(uv), t(dist)),
          jcam.undistort_pixels(KJ, jnp.asarray(uv), jnp.asarray(dist)), atol=1e-3)
    nxy = (p[:, :2] / p[:, 2:]).astype(np.float32)
    close(tcam.radtan_distort(t(nxy), t(dist)),
          jcam.radtan_distort(jnp.asarray(nxy), jnp.asarray(dist)))
    kb = np.array([0.0035, 0.0007, -0.002, 0.0002], np.float32)
    close(tcam.kb8_project(KT, t(kb), t(p)), jcam.kb8_project(KJ, jnp.asarray(kb), jnp.asarray(p)),
          atol=1e-3)
    close(tcam.kb8_project_jacobian(KT, t(kb), t(p)),
          jcam.kb8_project_jacobian(KJ, jnp.asarray(kb), jnp.asarray(p)), atol=1e-4)
    close(tcam.kb8_unproject(KT, t(kb), t(uv)),
          jcam.kb8_unproject(KJ, jnp.asarray(kb), jnp.asarray(uv)))


def test_triangulation_matches_jax():
    """Points within 1e-4 absolute + 1e-5 relative, depths within 1e-4,
    parallax within 1e-5 and the validity mask identical, for noisy
    two-view correspondences with outliers."""
    rng = np.random.RandomState(5)
    pts = scene(80, 5)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.asarray(jse3.exp(jnp.asarray([0.02, -0.05, 0.01, 0.4, 0.05, 0.1])))
    uv1 = np.asarray(jcam.project(KJ, jse3.apply(jnp.asarray(T1), jnp.asarray(pts))))
    uv2 = np.asarray(jcam.project(KJ, jse3.apply(jnp.asarray(T2), jnp.asarray(pts))))
    uv2 = (uv2 + rng.normal(0, 0.5, uv2.shape)).astype(np.float32)
    uv2[:8] += 40.0                                   # reprojection outliers
    b1 = np.asarray(jcam.unproject(KJ, jnp.asarray(uv1)))
    b2 = np.asarray(jcam.unproject(KJ, jnp.asarray(uv2)))
    T1b = np.broadcast_to(T1, (80, 4, 4)).copy()
    T2b = np.broadcast_to(T2, (80, 4, 4)).copy()
    pj, okj = jtri.triangulate_and_check(jnp.asarray(T1b), jnp.asarray(T2b),
                                         jnp.asarray(b1), jnp.asarray(b2), KJ,
                                         jnp.asarray(uv1), jnp.asarray(uv2))
    pt, okt = ttri.triangulate_and_check(t(T1b), t(T2b), t(b1), t(b2), KT,
                                         t(uv1), t(uv2))
    close(pt, pj, atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert 50 < okt.sum() < 80
    close(ttri.depth_in(t(T2b), pt), jtri.depth_in(jnp.asarray(T2b), pj), atol=1e-4)
    close(ttri.parallax_cos(t(T1b), t(T2b), pt),
          jtri.parallax_cos(jnp.asarray(T1b), jnp.asarray(T2b), pj))


def test_pose_optimization_matches_jax():
    """Pose within 1e-4, identical inlier mask, on noisy observations with
    20% outliers and a masked-out block, from the same initial pose."""
    rng = np.random.RandomState(6)
    pts = scene(150, 6)
    T_true = jse3.exp(jnp.asarray([0.01, 0.02, -0.01, 0.1, -0.05, 0.08]))
    uv = np.asarray(jcam.project(KJ, jse3.apply(T_true, jnp.asarray(pts))))
    uv = (uv + rng.normal(0, 0.7, uv.shape)).astype(np.float32)
    uv[:30] += rng.uniform(20, 60, (30, 2)).astype(np.float32)
    level = rng.randint(0, 4, 150)
    inv_s2 = (1.2 ** (-2.0 * level)).astype(np.float32)
    mask = np.arange(150) >= 10
    T0 = np.asarray(jse3.exp(jnp.asarray([0.0, 0.01, 0.0, 0.05, 0.0, 0.0])))
    for rounds, iters in ((2, 7), (4, 10)):
        rj = jpo.pose_optimization(jnp.asarray(T0), KJ, jnp.asarray(pts), jnp.asarray(uv),
                                   jnp.asarray(inv_s2), jnp.asarray(mask),
                                   rounds=rounds, iters=iters)
        rt = tpo.pose_optimization(t(T0), KT, t(pts), t(uv), t(inv_s2), t(mask),
                                   rounds=rounds, iters=iters)
        close(rt.pose, rj.pose, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
        assert int(rt.n_inliers) == int(rj.n_inliers) > 90


def test_bundle_adjust_matches_jax():
    """Poses and points within 1e-3 relative (of the window's scale) on a
    4-keyframe window with one fixed keyframe and perturbed initial state."""
    rng = np.random.RandomState(7)
    n_kf, n_pts = 4, 100
    pts = scene(n_pts, 7)
    poses = np.stack([np.asarray(jse3.exp(jnp.asarray([0.0, 0.01 * i, 0.0, 0.3 * i, 0.0, 0.0])))
                      for i in range(n_kf)])
    kf = np.repeat(np.arange(n_kf), n_pts).astype(np.int32)
    pt = np.tile(np.arange(n_pts), n_kf).astype(np.int32)
    uv = np.asarray(jcam.project(KJ, jse3.apply(jnp.asarray(poses[kf]), jnp.asarray(pts[pt]))))
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    inv_s2 = np.ones(kf.shape[0], np.float32)
    valid = rng.rand(kf.shape[0]) < 0.9
    xi = np.concatenate([np.zeros((1, 6)), rng.normal(0, 0.01, (n_kf - 1, 6))])
    poses0 = np.asarray(jse3.retract(jnp.asarray(poses), jnp.asarray(xi.astype(np.float32))))
    pts0 = (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32)
    fixed = np.arange(n_kf) == 0
    rj = jba.bundle_adjust(jnp.asarray(poses0), jnp.asarray(fixed), jnp.asarray(pts0),
                           jba.BAObservations(jnp.asarray(kf), jnp.asarray(pt), jnp.asarray(uv),
                                              jnp.asarray(inv_s2), jnp.asarray(valid)),
                           KJ, iters=8)
    rt = tba.bundle_adjust(t(poses0), t(fixed), t(pts0),
                           tba.BAObservations(t(kf).long(), t(pt).long(), t(uv), t(inv_s2),
                                              t(valid)),
                           KT, iters=8)
    close(rt.poses, rj.poses, atol=1e-3 * 1.0, rtol=1e-3)
    close(rt.points, rj.points, atol=1e-3 * 7.0, rtol=1e-3)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    # and both actually converged towards the truth
    assert np.abs(rt.points.numpy() - pts).mean() < np.abs(pts0 - pts).mean()


@pytest.mark.parametrize("planar", [False, True])
def test_initialize_two_view_agrees_with_jax(planar):
    """Statistical (the RNG streams differ): both succeed; R within 1e-3
    and t up to scale within 1e-3; inlier sets agree on >= 98%."""
    rng = np.random.RandomState(8)
    n = 200
    if planar:
        xy = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n)], 1)
        pts = np.concatenate([xy, (5.0 + 0.3 * xy[:, :1] - 0.2 * xy[:, 1:])], 1)
    else:
        pts = scene(n, 8)
    pts = pts.astype(np.float32)
    T2 = jse3.exp(jnp.asarray([0.02, -0.04, 0.01, 0.4, 0.05, 0.1]))
    uv1 = np.asarray(jcam.project(KJ, jnp.asarray(pts)))
    uv2 = np.array(jcam.project(KJ, jse3.apply(T2, jnp.asarray(pts))))
    uv2[:20] += rng.uniform(20, 60, (20, 2)).astype(np.float32)   # outliers
    valid = np.ones(n, bool)
    rj = jinit.initialize_two_view(KJ, jnp.asarray(uv1), jnp.asarray(uv2),
                                   jnp.asarray(valid), jax.random.PRNGKey(0))
    g = torch.Generator()
    g.manual_seed(7)
    rt = tinit.initialize_two_view(KT, t(uv1), t(uv2), t(valid), g)
    assert bool(rj.ok) and bool(rt.ok)
    Rj, Rt = np.asarray(rj.T_21)[:3, :3], rt.T_21[:3, :3].numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-3)
    tj, tt = np.asarray(rj.T_21)[:3, 3], rt.T_21[:3, 3].numpy()
    np.testing.assert_allclose(tt / np.linalg.norm(tt), tj / np.linalg.norm(tj), atol=1e-3)
    assert np.mean(rt.inliers.numpy() == np.asarray(rj.inliers)) >= 0.98
    assert not rt.inliers[:20].any()
