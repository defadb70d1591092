"""Sim(3) geometry and the relocalization / loop-closing solvers of the
PyTorch port (RANSAC PnP, Horn + Sim3 RANSAC, reprojection Sim3
refinement, the essential-graph optimiser) against the JAX package, on
the CPU, from the same numpy inputs. RANSAC stages draw other samples
than JAX's, so they are held to outcomes: the recovered transform and the
inlier sets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.geometry import camera as jcam
from multi_orbslam3_tpu.geometry import se3 as jse3
from multi_orbslam3_tpu.geometry import sim3 as jsim3
from multi_orbslam3_tpu.opt import pnp as jpnp
from multi_orbslam3_tpu.opt import pose_graph as jpg
from multi_orbslam3_tpu.opt import sim3_solve as jss
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.geometry import camera as tcam
from multi_orbslam3_tpu_torch.geometry import sim3 as tsim3
from multi_orbslam3_tpu_torch.opt import pnp as tpnp
from multi_orbslam3_tpu_torch.opt import pose_graph as tpg
from multi_orbslam3_tpu_torch.opt import sim3_solve as tss

KV = (400.0, 400.0, 320.0, 240.0)
KJ = jcam.PinholeK(*[jnp.float32(v) for v in KV])
KT = tcam.PinholeK(*[torch.tensor(v) for v in KV])


def t(a):
    return torch.from_numpy(np.array(a))


def gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def close_sim3(S_t, S_j, atol):
    for a, b in zip(S_t, S_j):
        close(a, b, atol)


def zetas(seed, n=40):
    """Sim3 tangents covering both Taylor branches (|sigma| < 1e-4,
    theta < 1e-4, both) and general ones."""
    rng = np.random.RandomState(seed)
    z = np.concatenate([rng.normal(0, 0.6, (n, 6)), rng.normal(0, 0.3, (n, 1))], 1)
    z[0] = 0.0
    z[1, :3], z[2, 6], z[3, :3], z[3, 6] = 1e-6, 5e-5, 2e-5, -3e-5
    z[4, 6], z[5, :3] = 1e-7, 0.0
    return z.astype(np.float32)


def test_sim3_matches_jax():
    """exp, log, compose, inverse, apply, retract, stack/unstack within
    1e-5 of JAX, including the small-angle and small-scale branches, and
    log(exp(zeta)) = zeta within 1e-5."""
    z = zetas(0)
    Sj, St = jsim3.exp(jnp.asarray(z)), tsim3.exp(t(z))
    close_sim3(St, Sj, 1e-5)
    close(tsim3.log(St), jsim3.log(Sj), 1e-5)
    close(tsim3.log(St), z, 1e-5)
    z2 = zetas(1)[::-1].copy()
    Sj2, St2 = jsim3.exp(jnp.asarray(z2)), tsim3.exp(t(z2))
    close_sim3(tsim3.compose(St, St2), jsim3.compose(Sj, Sj2), 1e-5)
    close_sim3(tsim3.inverse(St), jsim3.inverse(Sj), 1e-5)
    close_sim3(tsim3.retract(St, t(z2)), jsim3.retract(Sj, jnp.asarray(z2)), 1e-5)
    p = np.random.RandomState(2).normal(0, 2, (len(z), 3)).astype(np.float32)
    close(tsim3.apply(St, t(p)), jsim3.apply(Sj, jnp.asarray(p)), 1e-5)
    close(tsim3.stack(St), jsim3.stack(Sj), 1e-6)
    close_sim3(tsim3.unstack(tsim3.stack(St)), Sj, 1e-6)
    close(tsim3.to_se3_scaled(St), jsim3.to_se3_scaled(Sj), 1e-5)
    back = interop.sim3_to_numpy(interop.sim3_from_numpy(
        {f: np.asarray(getattr(Sj, f)) for f in jsim3.Sim3._fields}))
    for f in jsim3.Sim3._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(Sj, f)))


# ----------------------------------------------------------------------
# PnP
# ----------------------------------------------------------------------

def pnp_scene(seed, n=200, outlier_frac=0.3):
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(3, 8, n)], 1).astype(np.float32)
    T = np.array(jse3.exp(jnp.asarray([0.05, -0.1, 0.03, 0.2, -0.1, 0.3])), np.float32)
    pc = X @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([KV[0] * pc[:, 0] / pc[:, 2] + KV[2],
                   KV[1] * pc[:, 1] / pc[:, 2] + KV[3]], 1)
    uv = uv + rng.normal(0, 0.3, uv.shape)
    out = rng.rand(n) < outlier_frac
    uv[out] += rng.uniform(20, 60, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    return X, uv.astype(np.float32), T, out


def test_dlt_pose_matches_jax():
    """Six exact correspondences: the DLT + Procrustes pose within 1e-4 of
    JAX's and of the true pose."""
    X, uv, T, _ = pnp_scene(0, n=6, outlier_frac=0.0)
    b = np.stack([(uv[:, 0] - KV[2]) / KV[0], (uv[:, 1] - KV[3]) / KV[1],
                  np.ones(6)], 1).astype(np.float32)
    # exact bearings: re-project without noise
    pc = X @ T[:3, :3].T + T[:3, 3]
    b[:, :2] = pc[:, :2] / pc[:, 2:3]
    want = np.asarray(jpnp._dlt_pose(jnp.asarray(X), jnp.asarray(b)))
    got = tpnp._dlt_pose(t(X), t(b))
    close(got, want, 1e-4)
    np.testing.assert_allclose(got.numpy(), T, atol=1e-3)


def test_pnp_ransac_with_outliers_matches_jax():
    """30% outliers: the pose within 1e-2 rad / 1e-2 m of the truth, and
    the inlier set agreeing with JAX's on >= 95% of the correspondences."""
    X, uv, T, out = pnp_scene(1)
    n = X.shape[0]
    valid = np.ones(n, bool)
    is2 = np.ones(n, np.float32)
    rj = jpnp.pnp_ransac(KJ, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid),
                         jnp.asarray(is2), jax.random.PRNGKey(0))
    rt = tpnp.pnp_ransac(KT, t(X), t(uv), t(valid), t(is2), gen(0))
    assert bool(rt.ok) and bool(rj.ok)
    dT = np.linalg.inv(T) @ rt.pose.numpy()
    rot_err = np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2, -1, 1))
    assert rot_err < 1e-2 and np.linalg.norm(rt.pose.numpy()[:3, 3] - T[:3, 3]) < 1e-2
    inl_t, inl_j = rt.inliers.numpy(), np.asarray(rj.inliers)
    assert np.mean(inl_t == inl_j) >= 0.95
    assert inl_t[out].mean() < 0.05 and inl_t[~out].mean() > 0.9
    assert int(rt.n_inliers) == int(inl_t.sum())


# ----------------------------------------------------------------------
# Sim3 from 3D-3D
# ----------------------------------------------------------------------

@pytest.mark.parametrize("weighted,fix_scale", [(False, False), (True, False), (False, True)])
def test_horn_sim3_matches_jax(weighted, fix_scale):
    rng = np.random.RandomState(3)
    p = rng.randn(4, 50, 3).astype(np.float32)
    S = jsim3.exp(jnp.asarray([0.1, -0.2, 0.3, 0.5, -0.4, 0.2, 0.3]))
    q = np.asarray(jsim3.apply(S, jnp.asarray(p))) + rng.normal(0, 0.01, p.shape).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (4, 50)).astype(np.float32) if weighted else None
    Sj = jss.horn_sim3(jnp.asarray(p), jnp.asarray(q),
                       None if w is None else jnp.asarray(w), fix_scale=fix_scale)
    St = tss.horn_sim3(t(p), t(q), None if w is None else t(w), fix_scale=fix_scale)
    close_sim3(St, Sj, 1e-5)


def test_sim3_ransac_with_outliers():
    """tests/test_loop.py's RANSAC case: accepted, the 25% outliers
    rejected, the scale within 2%; the inlier set agrees with JAX's."""
    rng = np.random.RandomState(2)
    M = 120
    p = (rng.randn(M, 3) * 2.0).astype(np.float32)
    S_true = jsim3.exp(jnp.asarray([0.05, 0.1, -0.1, 0.8, 0.2, -0.3, 0.2]))
    q = np.array(jsim3.apply(S_true, jnp.asarray(p)))
    q[:30] += rng.uniform(1.0, 3.0, (30, 3))
    rj = jss.sim3_ransac(jnp.asarray(p), jnp.asarray(q), jnp.ones(M, bool),
                         jax.random.PRNGKey(0), inlier_th=0.1)
    rt = tss.sim3_ransac(t(p), t(q), torch.ones(M, dtype=torch.bool), gen(0),
                         inlier_th=0.1)
    assert bool(rt.ok)
    inl = rt.inliers.numpy()
    assert inl[:30].mean() < 0.2 and inl[30:].mean() > 0.9
    np.testing.assert_allclose(float(rt.S.s), float(S_true.s), rtol=0.02)
    assert np.mean(inl == np.asarray(rj.inliers)) >= 0.95


def test_optimize_sim3_reprojection_matches_jax():
    """The two-way reprojection refinement from the same seed Sim3: the
    refined (R, t, s) within 1e-4 of JAX's, the inlier masks equal, and
    closer to the truth than the seed."""
    rng = np.random.RandomState(4)
    M = 80
    p_cand = np.stack([rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M),
                       rng.uniform(3, 7, M)], 1).astype(np.float32)
    S_true = jsim3.exp(jnp.asarray([0.02, -0.03, 0.01, 0.1, 0.05, -0.05, 0.05]))
    p_cur = np.asarray(jsim3.apply(S_true, jnp.asarray(p_cand)))
    T_cur = np.array(jse3.exp(jnp.asarray([0.0, 0.05, 0.0, 0.1, 0.0, 0.0])), np.float32)
    T_cand = np.eye(4, dtype=np.float32)

    def proj(T, p):
        pc = p @ T[:3, :3].T + T[:3, 3]
        return np.stack([KV[0] * pc[:, 0] / pc[:, 2] + KV[2],
                         KV[1] * pc[:, 1] / pc[:, 2] + KV[3]], 1).astype(np.float32)

    uv_cur = proj(T_cur, p_cur) + rng.normal(0, 0.5, (M, 2)).astype(np.float32)
    uv_cand = proj(T_cand, p_cand) + rng.normal(0, 0.5, (M, 2)).astype(np.float32)
    uv_cur[:6] += 40.0                                  # a few outliers
    has_cur, has_cand = rng.rand(M) < 0.8, rng.rand(M) < 0.8
    is2 = np.ones(M, np.float32)
    S0 = jsim3.retract(S_true, jnp.asarray([0.01, 0.0, -0.01, 0.05, 0.0, 0.02, 0.02]))
    args = (T_cur, T_cand, p_cand, uv_cur, has_cur, p_cur, uv_cand, has_cand, is2, is2)
    Sj, fj, bj = jss.optimize_sim3_reprojection(S0, KJ, *map(jnp.asarray, args))
    S0t = tsim3.Sim3(*(t(x) for x in S0))
    St, ft, bt = tss.optimize_sim3_reprojection(S0t, KT, *map(t, args))
    close_sim3(St, Sj, 1e-4)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    err = lambda S: np.abs(np.asarray(jsim3.log(jsim3.compose(  # noqa: E731
        jsim3.Sim3(*map(jnp.asarray, S)), jsim3.inverse(S_true))))).max()
    assert err([x.numpy() for x in St]) < err(S0)


# ----------------------------------------------------------------------
# Pose graph
# ----------------------------------------------------------------------

def graph(seed, K=16):
    """A chain with extra loop edges, measured at the true poses; the
    nodes are then perturbed."""
    rng = np.random.RandomState(seed)
    z = np.concatenate([rng.normal(0, 0.3, (K, 3)), rng.normal(0, 1.0, (K, 3)),
                        rng.normal(0, 0.1, (K, 1))], 1).astype(np.float32)
    S_true = np.asarray(jsim3.stack(jsim3.exp(jnp.asarray(z))))
    ei = np.concatenate([np.arange(1, K), [K - 1, K - 2, 12, 5]]).astype(np.int32)
    ej = np.concatenate([np.arange(0, K - 1), [0, 3, 2, 9]]).astype(np.int32)
    w = np.concatenate([np.ones(K - 1), [100.0, 1.0, 1.0, 1.0]]).astype(np.float32)
    valid = np.ones(len(ei), bool)
    valid[-1] = False
    dz = rng.normal(0, 0.05, z.shape).astype(np.float32)
    S_pert = np.asarray(jsim3.stack(jsim3.retract(jsim3.unstack(jnp.asarray(S_true)),
                                                  jnp.asarray(dz))))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return S_true, S_pert, (ei, ej, w, valid), fixed


@pytest.mark.parametrize("right", [False, True])
def test_edge_jacobians_match_jax_jacfwd(right):
    """Per-edge residuals and both Jacobians within 1e-4 of JAX's
    vmap(jacfwd), left (camera-frame) and right (world-frame, the yaw-only
    mode) perturbations."""
    S_true, S_pert, (ei, ej, w, valid), _ = graph(5)
    Ej = jpg.make_edges(jnp.asarray(S_true), *map(jnp.asarray, (ei, ej, w, valid)))
    Et = tpg.make_edges(t(S_true), *map(t, (ei, ej, w, valid)))
    close(Et.S_ij, Ej.S_ij, 1e-5)
    zero = jnp.zeros(7)
    Si, Sj = jnp.asarray(S_pert)[ei], jnp.asarray(S_pert)[ej]

    def jac(arg):
        return jax.vmap(lambda a, b, c: jax.jacfwd(jpg._edge_residual, argnums=arg)(
            a, b, c, zero, zero, right))(Ej.S_ij, Si, Sj)

    r_j = jax.vmap(lambda a, b, c: jpg._edge_residual(a, b, c, zero, zero, right))(
        Ej.S_ij, Si, Sj)
    r_t, Ji, Jj = tpg.edge_jacobians(Et, t(S_pert), right)
    close(r_t, r_j, 1e-5)
    close(Ji, jac(3), 1e-4)
    close(Jj, jac(4), 1e-4)


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("fix_scale,yaw_only", [(False, False), (True, False), (False, True)])
def test_optimize_pose_graph_matches_jax(solver, fix_scale, yaw_only):
    """16 nodes, 5 iterations: the optimised nodes within 1e-4 of JAX's;
    the fixed node does not move; with yaw_only every pose keeps its
    gravity column (R e_z)."""
    _, S_pert, (ei, ej, w, valid), fixed = graph(6)
    S_true, _, _, _ = graph(6)
    Ej = jpg.make_edges(jnp.asarray(S_true), *map(jnp.asarray, (ei, ej, w, valid)))
    Et = tpg.make_edges(t(S_true), *map(t, (ei, ej, w, valid)))
    want = np.asarray(jpg.optimize_pose_graph(jnp.asarray(S_pert), jnp.asarray(fixed), Ej,
                                              iters=5, fix_scale=fix_scale,
                                              yaw_only=yaw_only, solver=solver))
    got = tpg.optimize_pose_graph(t(S_pert), t(fixed), Et, iters=5, fix_scale=fix_scale,
                                  yaw_only=yaw_only, solver=solver)
    close(got, want, 1e-4)
    np.testing.assert_array_equal(got.numpy()[0], S_pert[0])
    R_new = got.numpy()[:, :9].reshape(-1, 3, 3)
    R_old = S_pert[:, :9].reshape(-1, 3, 3)
    if yaw_only:
        np.testing.assert_allclose(R_new[:, :, 2], R_old[:, :, 2], atol=1e-5)
    else:
        assert np.abs(R_new[:, :, 2] - R_old[:, :, 2]).max() > 1e-3
    if fix_scale:
        np.testing.assert_allclose(got.numpy()[:, 12], S_pert[:, 12], atol=1e-6)
    assert np.abs(got.numpy() - S_pert).max() > 1e-3      # it moved
