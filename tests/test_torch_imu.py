"""IMU preintegration and the three inertial solvers of the port against
the JAX package on the same numpy inputs (made from a seed).

Tolerances: preintegration 1e-5 absolute (covariance 1e-4 relative); each
inertial Jacobian 1e-4 relative to its largest entry, every batch row; the
solvers as stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu import config as jcfg
from multi_orbslam3_tpu.geometry import camera as jcam
from multi_orbslam3_tpu.geometry import se3 as jse3
from multi_orbslam3_tpu.geometry import so3 as jso3
from multi_orbslam3_tpu.imu import preintegration as jpre
from multi_orbslam3_tpu.opt import inertial_ba as jiba
from multi_orbslam3_tpu.opt import inertial_init as jinit
from multi_orbslam3_tpu.opt import local_ba as jlba
from multi_orbslam3_tpu.opt import vi_pose_opt as jvi
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.geometry import camera as tcam
from multi_orbslam3_tpu_torch.imu import preintegration as tpre
from multi_orbslam3_tpu_torch.opt import inertial_ba as tiba
from multi_orbslam3_tpu_torch.opt import inertial_init as tinit
from multi_orbslam3_tpu_torch.opt import local_ba as tlba
from multi_orbslam3_tpu_torch.opt import vi_pose_opt as tvi

# several test processes share the machine's cores; torch's intra-op pool
# spinning on all of them makes the many small ops here wait on each other
torch.set_num_threads(2)

G = 9.81
G_W = np.array([0.0, 0.0, -G], np.float32)
T_BC = np.asarray(jse3.make(jso3.exp(jnp.asarray([0.05, -0.1, 0.6])),
                            jnp.asarray([0.08, -0.02, 0.05])), np.float32)


def jcalib():
    return jpre.ImuCalib.from_config(jcfg.IMUConfig())


def tcalib():
    return tpre.ImuCalib.from_config(tcfg.IMUConfig())


def t(a):
    return torch.from_numpy(np.array(a))


def to_torch_preint(p) -> tpre.Preintegrated:
    return interop.preintegrated_from_numpy(
        {f: np.asarray(getattr(p, f)) for f in p._fields})


def window(seed, S=32, n_pad=9, bias=True):
    rng = np.random.RandomState(seed)
    acc = (rng.randn(S, 3) * 0.8 + [0, 0, 9.81]).astype(np.float32)
    gyro = (rng.randn(S, 3) * 0.3).astype(np.float32)
    dt = np.full(S, 0.005, np.float32)
    dt[S - n_pad:] = 0.0                   # trailing padding
    if n_pad:
        dt[3] = 0.0                        # and one padding slot inside
    bg = (rng.randn(3) * 0.01 * bias).astype(np.float32)
    ba = (rng.randn(3) * 0.1 * bias).astype(np.float32)
    return acc, gyro, dt, bg, ba


def assert_preint_close(pt, pj):
    for name in pj._fields:
        a, b = np.asarray(getattr(pj, name)), getattr(pt, name).numpy()
        if name == "cov":
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4 * np.abs(a).max(),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preintegrate_equals_jax(seed):
    acc, gyro, dt, bg, ba = window(seed)
    pj = jpre.preintegrate(*(jnp.asarray(x) for x in (acc, gyro, dt, bg, ba)),
                           jcalib())
    pt = tpre.preintegrate(*(t(x) for x in (acc, gyro, dt, bg, ba)), tcalib())
    assert_preint_close(pt, pj)


def test_padding_slots_keep_the_state_exactly():
    """A window with padding equals the same samples without it bit for
    bit, and an all-padding window is the empty window."""
    acc, gyro, dt, bg, ba = window(5, n_pad=0)
    acc2 = np.concatenate([acc[:10], 7.0 + acc[:6], acc[10:]])
    gyro2 = np.concatenate([gyro[:10], gyro[:6], gyro[10:]])
    dt2 = np.concatenate([dt[:10], np.zeros(6, np.float32), dt[10:]])
    # a power-of-two length on both sides keeps the reduction trees alike
    acc2, gyro2, dt2 = acc2[:32], gyro2[:32], dt2[:32]
    a = tpre.preintegrate(t(acc[:26]), t(gyro[:26]), t(dt[:26]), t(bg), t(ba),
                          tcalib())
    b = tpre.preintegrate(t(acc2), t(gyro2), t(dt2), t(bg), t(ba), tcalib())
    for name in a._fields:
        np.testing.assert_allclose(getattr(b, name).numpy(),
                                   getattr(a, name).numpy(), rtol=2e-6,
                                   atol=1e-7, err_msg=name)
    e = tpre.preintegrate(t(acc), t(gyro), t(np.zeros_like(dt)), t(bg), t(ba),
                          tcalib())
    empty = tpre.empty_preintegrated(t(bg), t(ba))
    for name in e._fields:
        np.testing.assert_array_equal(getattr(e, name).numpy(),
                                      getattr(empty, name).numpy(), err_msg=name)


def test_merge_bias_correction_and_prediction_equal_jax():
    acc, gyro, dt, bg, ba = window(3, n_pad=0)
    bg2, ba2 = bg + 0.004, ba - 0.03
    args1 = (acc[:16], gyro[:16], dt[:16], bg, ba)
    args2 = (acc[16:], gyro[16:], dt[16:], bg2, ba2)
    j1 = jpre.preintegrate(*(jnp.asarray(x) for x in args1), jcalib())
    j2 = jpre.preintegrate(*(jnp.asarray(x) for x in args2), jcalib())
    t1 = tpre.preintegrate(*(t(x) for x in args1), tcalib())
    t2 = tpre.preintegrate(*(t(x) for x in args2), tcalib())
    assert_preint_close(tpre.merge_preintegrated(t1, t2),
                        jpre.merge_preintegrated(j1, j2))
    bq_g, bq_a = bg + 0.002, ba + 0.01
    for a, b in zip(tpre.bias_corrected_delta(t1, t(bq_g), t(bq_a)),
                    jpre.bias_corrected_delta(j1, jnp.asarray(bq_g),
                                              jnp.asarray(bq_a))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    R = np.asarray(jso3.exp(jnp.asarray([0.1, -0.2, 0.3])))
    v, p = np.float32([0.3, -0.1, 0.2]), np.float32([1.0, 2.0, -0.5])
    got = tpre.predict_state(t(R), t(v), t(p), t1, t(G_W), t(bq_g), t(bq_a))
    want = jpre.predict_state(jnp.asarray(R), jnp.asarray(v), jnp.asarray(p), j1,
                              jnp.asarray(G_W), jnp.asarray(bq_g),
                              jnp.asarray(bq_a))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_merging_two_windows_equals_integrating_them_as_one():
    acc, gyro, dt, _, _ = window(4, S=24, n_pad=0, bias=False)
    z = torch.zeros(3)
    full = tpre.preintegrate(t(acc), t(gyro), t(dt), z, z, tcalib())
    h1 = tpre.preintegrate(t(acc[:12]), t(gyro[:12]), t(dt[:12]), z, z, tcalib())
    h2 = tpre.preintegrate(t(acc[12:]), t(gyro[12:]), t(dt[12:]), z, z, tcalib())
    merged = tpre.merge_preintegrated(h1, h2)
    for name in ("dR", "dV", "dP"):
        np.testing.assert_allclose(getattr(merged, name).numpy(),
                                   getattr(full, name).numpy(), atol=1e-5)
    np.testing.assert_allclose(merged.dT.numpy(), full.dT.numpy(), atol=1e-6)
    for name in ("JRg", "JPa"):
        np.testing.assert_allclose(getattr(merged, name).numpy(),
                                   getattr(full, name).numpy(), atol=1e-3)


def test_flat_round_trip_and_layout_equal_jax():
    acc, gyro, dt, bg, ba = window(6)
    pj = jpre.preintegrate(*(jnp.asarray(x) for x in (acc, gyro, dt, bg, ba)),
                           jcalib())
    pt = to_torch_preint(pj)
    flat = tpre.preint_to_flat(pt)
    assert flat.shape == (tpre.FLAT_DIM,) and flat.dtype == np.float32
    np.testing.assert_array_equal(flat, jpre.preint_to_flat(pj))
    assert (tpre.FLAT_DIM, tpre.FLAT_DT, tpre.FLAT_BG, tpre.FLAT_BA) == \
        (jpre.FLAT_DIM, jpre.FLAT_DT, jpre.FLAT_BG, jpre.FLAT_BA)
    back = tpre.flat_to_preint(flat)
    for name in pt._fields:
        assert getattr(back, name).shape == getattr(pt, name).shape
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      getattr(pt, name).numpy())
    d = interop.preintegrated_to_numpy(pt)
    assert set(d) == set(pj._fields)


# ----------------------------------------------------------------------
# a synthetic keyframe chain with exactly consistent IMU samples
# ----------------------------------------------------------------------

def simulate(n_kf=8, samples_per_kf=10, dt=0.01, bg=np.zeros(3), ba=np.zeros(3)):
    R, v, p = np.eye(3), np.array([0.3, 0.0, 0.1]), np.zeros(3)
    kf_R, kf_p, kf_v = [R.copy()], [p.copy()], [v.copy()]
    acc_w, gyr_w, dt_w, wa, wg, wd = [], [], [], [], [], []
    tt = np.arange(n_kf * samples_per_kf) * dt
    a_prof = np.stack([0.6 * np.sin(2 * tt), 0.4 * np.cos(3 * tt),
                       0.3 * np.sin(tt)], 1)
    w_prof = np.stack([0.2 * np.sin(tt), 0.3 * np.cos(2 * tt),
                       0.25 * np.sin(3 * tt)], 1)
    for k in range(len(tt)):
        a_b, w_b = a_prof[k], w_prof[k]
        wa.append(a_b - R.T @ G_W.astype(np.float64) + ba)
        wg.append(w_b + bg)
        wd.append(dt)
        a_w = R @ a_b
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
        R = R @ np.asarray(jso3.exp(jnp.asarray(w_b * dt)), np.float64)
        if (k + 1) % samples_per_kf == 0:
            kf_R.append(R.copy()); kf_p.append(p.copy()); kf_v.append(v.copy())
            acc_w.append(np.stack(wa)); gyr_w.append(np.stack(wg))
            dt_w.append(np.asarray(wd))
            wa, wg, wd = [], [], []
    f = np.float32
    return (np.stack(kf_R).astype(f), np.stack(kf_p).astype(f),
            np.stack(kf_v).astype(f), np.stack(acc_w).astype(f),
            np.stack(gyr_w).astype(f), np.stack(dt_w).astype(f))


def stack_preints(acc_w, gyr_w, dt_w, bg0, ba0):
    """Preintegrate each window with the JAX package (entry 0 a dummy);
    both packages then get the same windows."""
    outs = [jpre.empty_preintegrated()] + [
        jpre.preintegrate(jnp.asarray(acc_w[i]), jnp.asarray(gyr_w[i]),
                          jnp.asarray(dt_w[i]), jnp.asarray(bg0),
                          jnp.asarray(ba0), jcalib())
        for i in range(acc_w.shape[0])]
    pj = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *outs)
    return pj, to_torch_preint(pj)


def cam_poses(kf_R, kf_p, T_bc):
    T_wb = np.tile(np.eye(4, dtype=np.float32), (kf_R.shape[0], 1, 1))
    T_wb[:, :3, :3] = kf_R
    T_wb[:, :3, 3] = kf_p
    return (np.linalg.inv(T_bc)[None] @ np.linalg.inv(T_wb)).astype(np.float32)


def rel_close(got, want, tol, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{msg}: {err:.3g} of the largest entry {scale:.3g}"


def test_vi_pose_jacobian_equals_jax_jacfwd():
    kf_R, kf_p, kf_v, acc_w, gyr_w, dt_w = simulate(n_kf=4)
    pj, pt = stack_preints(acc_w, gyr_w, dt_w, np.zeros(3, np.float32),
                           np.full(3, 0.01, np.float32))
    T = cam_poses(kf_R, kf_p, T_BC)
    bg = np.float32([0.004, -0.002, 0.003])
    ba = np.float32([0.02, 0.01, -0.03])
    for j in (1, 2, 3):                    # every pair, as a batch of one each
        pre_j = jax.tree_util.tree_map(lambda x: x[j], pj)
        args = (jnp.asarray(T[j]), jnp.asarray(kf_v[j] + 0.05), jnp.asarray(bg),
                jnp.asarray(ba), jnp.asarray(T[j - 1]), jnp.asarray(kf_v[j - 1]),
                pre_j, jnp.asarray(G_W), jnp.asarray(T_BC))
        with jax.default_matmul_precision("highest"):
            r_want = jvi._vi_residual(jnp.zeros(15), *args)
            J_want = jax.jacfwd(jvi._vi_residual)(jnp.zeros(15), *args)
        r, J = tvi.inertial_terms(
            t(T[j]), t(kf_v[j] + 0.05), t(bg), t(ba), t(T[j - 1]), t(kf_v[j - 1]),
            tpre.index_preintegrated(pt, j), t(G_W), t(T_BC))
        assert J.shape == (9, 15) and J.dtype == torch.float32
        rel_close(r, r_want, 1e-4, f"residual, pair {j}")
        rel_close(J, J_want, 1e-4, f"Jacobian, pair {j}")


def test_inertial_ba_pair_jacobians_equal_jax_jacfwd_on_every_pair():
    kf_R, kf_p, kf_v, acc_w, gyr_w, dt_w = simulate(n_kf=6)
    pj, pt = stack_preints(acc_w, gyr_w, dt_w, np.full(3, 0.002, np.float32),
                           np.zeros(3, np.float32))
    T = cam_poses(kf_R, kf_p, T_BC)
    rng = np.random.RandomState(2)
    bg = (rng.randn(7, 3) * 0.005).astype(np.float32)
    ba = (rng.randn(7, 3) * 0.02).astype(np.float32)
    v = kf_v + (rng.randn(7, 3) * 0.05).astype(np.float32)
    r, Ji, Jj = tiba.pair_terms(t(T), t(v), t(bg), t(ba), pt, t(G_W), t(T_BC))
    assert Ji.shape == Jj.shape == (6, 9, 15)
    for j in range(1, 7):
        pre_j = jax.tree_util.tree_map(lambda x: x[j], pj)
        args = (jnp.asarray(T[j - 1]), jnp.asarray(T[j]), jnp.asarray(v[j - 1]),
                jnp.asarray(v[j]), jnp.asarray(bg[j - 1]), jnp.asarray(ba[j - 1]),
                pre_j, jnp.asarray(G_W), jnp.asarray(T_BC))
        z = jnp.zeros(15)
        with jax.default_matmul_precision("highest"):
            r_want = jiba._inertial_residual(z, z, *args)
            Ji_want = jax.jacfwd(jiba._inertial_residual, argnums=0)(z, z, *args)
            Jj_want = jax.jacfwd(jiba._inertial_residual, argnums=1)(z, z, *args)
        rel_close(r[j - 1], r_want, 1e-4, f"residual, pair {j}")
        rel_close(Ji[j - 1], Ji_want, 1e-4, f"d/d delta_i, pair {j}")
        rel_close(Jj[j - 1], Jj_want, 1e-4, f"d/d delta_j, pair {j}")


def test_inertial_init_jacobian_equals_jax_jacfwd():
    kf_R, kf_p, kf_v, acc_w, gyr_w, dt_w = simulate(n_kf=6)
    pj, pt = stack_preints(acc_w, gyr_w, dt_w, np.zeros(3, np.float32),
                           np.zeros(3, np.float32))
    rng = np.random.RandomState(4)
    theta = np.concatenate([[0.05, -0.03, 0.4], rng.randn(3) * 0.01,
                            rng.randn(3) * 0.05,
                            (kf_v + rng.randn(7, 3) * 0.05).reshape(-1)]
                           ).astype(np.float32)
    sig = (1e-2, 5e-2, 5e-2)
    with jax.default_matmul_precision("highest"):
        r_want = jinit._residuals(jnp.asarray(theta), jnp.asarray(kf_R),
                                  jnp.asarray(kf_p), pj, G, sig)
        J_want = jax.jacfwd(jinit._residuals)(jnp.asarray(theta), jnp.asarray(kf_R),
                                              jnp.asarray(kf_p), pj, G, sig)
    r, J = tinit.residuals_and_jacobian(t(theta), t(kf_R), t(kf_p), pt, G, sig)
    assert J.shape == (54, 30) and J.dtype == torch.float32
    rel_close(r, r_want, 1e-4, "residuals")
    for pair in range(6):                  # every pair's rows of the stack
        rows = slice(9 * pair, 9 * pair + 9)
        rel_close(J[rows], J_want[rows], 1e-4, f"Jacobian rows of pair {pair}")


@pytest.mark.parametrize("n_visual", [0, 60])
def test_pose_inertial_optimization_equals_jax(n_visual):
    """Pose to 1e-3 (tangent norm), velocity and biases to 1e-3, the same
    visual inlier set."""
    kf_R, kf_p, kf_v, acc_w, gyr_w, dt_w = simulate(n_kf=4)
    pj, pt = stack_preints(acc_w, gyr_w, dt_w, np.zeros(3, np.float32),
                           np.zeros(3, np.float32))
    T = cam_poses(kf_R, kf_p, T_BC)
    rng = np.random.RandomState(11)
    n = 60
    p_c = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                    rng.uniform(3, 7, n)], 1).astype(np.float32)
    p_w = np.asarray(jse3.apply(jse3.inverse(jnp.asarray(T[3])), jnp.asarray(p_c)))
    Kv = (400.0, 400.0, 320.0, 240.0)
    Kj = jcam.PinholeK(*[jnp.float32(x) for x in Kv])
    Kt = tcam.PinholeK(*[torch.tensor(x) for x in Kv])
    uv = np.asarray(jcam.project(Kj, jnp.asarray(p_c)))
    uv = (uv + rng.randn(n, 2) * 0.5).astype(np.float32)
    uv[:5] += 30.0                          # gross outliers
    mask = np.arange(n) < n_visual
    T0 = np.asarray(jse3.retract(jnp.asarray(T[3]),
                                 jnp.asarray(rng.randn(6) * 0.03, jnp.float32)))
    v0 = (kf_v[3] + rng.randn(3) * 0.2).astype(np.float32)
    z = np.zeros(3, np.float32)
    a = (T0, v0, z, z, T[2], kf_v[2], z, z)
    want = jvi.pose_inertial_optimization(
        *(jnp.asarray(x) for x in a), jax.tree_util.tree_map(lambda x: x[3], pj),
        Kj, jnp.asarray(p_w), jnp.asarray(uv), jnp.ones(n), jnp.asarray(mask),
        jnp.asarray(G_W), jnp.asarray(T_BC), rounds=2, iters=8)
    got = tvi.pose_inertial_optimization(
        *(t(x) for x in a), tpre.index_preintegrated(pt, 3), Kt, t(p_w), t(uv),
        torch.ones(n), t(mask), t(G_W), t(T_BC), rounds=2, iters=8)
    err = float(jnp.linalg.norm(jse3.log(jse3.compose(
        jnp.asarray(got.pose.numpy()), jse3.inverse(want.pose)))))
    assert err < 1e-3, err
    np.testing.assert_allclose(got.velocity.numpy(), np.asarray(want.velocity), atol=1e-3)
    np.testing.assert_allclose(got.bg.numpy(), np.asarray(want.bg), atol=1e-3)
    np.testing.assert_allclose(got.ba.numpy(), np.asarray(want.ba), atol=1e-3)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_inertial_init_equals_jax(fix_scale):
    """Scale to 1e-3 relative, gravity direction to 1e-3 rad, gyro bias and
    velocities to 1e-3. The accelerometer bias is held to 5e-3: its prior is
    stiff (1e5) but this short window observes it weakly, so float32
    round-off in J^T J moves it more than the other parameters."""
    bg_true = np.array([0.02, -0.015, 0.01])
    kf_R, kf_p, kf_v, acc_w, gyr_w, dt_w = simulate(bg=bg_true)
    pj, pt = stack_preints(acc_w, gyr_w, dt_w, np.zeros(3, np.float32),
                           np.zeros(3, np.float32))
    s_true = 1.0 if fix_scale else 2.5
    tilt = np.asarray(jso3.exp(jnp.asarray([0.06, -0.04, 0.0])), np.float32)
    R_vis = np.einsum("ij,njk->nik", tilt.T, kf_R).astype(np.float32)
    p_vis = ((kf_p @ tilt) / s_true).astype(np.float32)
    want = jinit.inertial_init(jnp.asarray(R_vis), jnp.asarray(p_vis), pj, G=G,
                               fix_scale=fix_scale)
    got = tinit.inertial_init(t(R_vis), t(p_vis), pt, G=G, fix_scale=fix_scale)
    assert abs(float(got.scale) - s_true) / s_true < 0.02
    assert abs(float(got.scale) - float(want.scale)) < 1e-3 * float(want.scale)
    if fix_scale:
        assert abs(float(got.scale) - 1.0) < 1e-5
    g_got = got.R_wg.numpy()[:, 2]
    g_want = np.asarray(want.R_wg)[:, 2]
    assert np.arccos(np.clip(g_got @ g_want, -1, 1)) < 1e-3
    np.testing.assert_allclose(got.bg.numpy(), np.asarray(want.bg), atol=1e-3)
    np.testing.assert_allclose(got.ba.numpy(), np.asarray(want.ba), atol=5e-3)
    np.testing.assert_allclose(got.velocities.numpy(), np.asarray(want.velocities),
                               atol=1e-3)
    np.testing.assert_allclose(got.bg.numpy(), bg_true, atol=4e-3)


def test_inertial_bundle_adjust_equals_jax():
    """Poses to 1e-3 (tangent norm), velocities, biases and points to 1e-3,
    on a window with a rotated, offset T_bc and one invalid pair."""
    kf_R, kf_p, kf_v, acc_w, gyr_w, dt_w = simulate(n_kf=5)
    n_kf = kf_R.shape[0]
    pj, pt = stack_preints(acc_w, gyr_w, dt_w, np.zeros(3, np.float32),
                           np.zeros(3, np.float32))
    T_cw = cam_poses(kf_R, kf_p, T_BC)
    rng = np.random.RandomState(3)
    n_pts = 80
    p_c0 = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                     rng.uniform(3, 7, n_pts)], 1).astype(np.float32)
    pts = np.asarray(jse3.apply(jse3.inverse(jnp.asarray(T_cw[2])),
                                jnp.asarray(p_c0)))
    Kv = (400.0, 400.0, 320.0, 240.0)
    Kj = jcam.PinholeK(*[jnp.float32(x) for x in Kv])
    Kt = tcam.PinholeK(*[torch.tensor(x) for x in Kv])
    obs_kf = np.repeat(np.arange(n_kf, dtype=np.int32), n_pts)
    obs_pt = np.tile(np.arange(n_pts, dtype=np.int32), n_kf)
    uv = np.asarray(jax.vmap(lambda T: jcam.project(
        Kj, jse3.apply(T, jnp.asarray(pts))))(jnp.asarray(T_cw))).reshape(-1, 2)
    valid = np.ones(n_kf * n_pts, bool)
    valid[::17] = False
    poses0 = T_cw.copy()
    for i in range(1, n_kf):
        poses0[i] = np.asarray(jse3.retract(
            jnp.asarray(poses0[i]), jnp.asarray(rng.randn(6) * 0.02, jnp.float32)))
    v0 = (kf_v + rng.randn(n_kf, 3) * 0.1).astype(np.float32)
    pts0 = pts + rng.randn(n_pts, 3).astype(np.float32) * 0.05
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    pair_valid = np.ones(n_kf, bool)
    pair_valid[0] = False
    z = np.zeros((n_kf, 3), np.float32)
    ones = np.ones(n_kf * n_pts, np.float32)
    want = jiba.inertial_bundle_adjust(
        jnp.asarray(poses0), jnp.asarray(v0), jnp.asarray(z), jnp.asarray(z),
        jnp.asarray(fixed), jnp.asarray(pts0),
        jlba.BAObservations(kf=jnp.asarray(obs_kf), pt=jnp.asarray(obs_pt),
                            uv=jnp.asarray(uv), inv_sigma2=jnp.asarray(ones),
                            valid=jnp.asarray(valid)),
        pj, jnp.asarray(pair_valid), Kj, jnp.asarray(G_W), jnp.asarray(T_BC),
        iters=8)
    got = tiba.inertial_bundle_adjust(
        t(poses0), t(v0), t(z), t(z), t(fixed), t(pts0),
        tlba.BAObservations(kf=t(obs_kf), pt=t(obs_pt), uv=t(uv),
                            inv_sigma2=t(ones), valid=t(valid)),
        pt, t(pair_valid), Kt, t(G_W), t(T_BC), iters=8)
    for i in range(n_kf):
        err = float(jnp.linalg.norm(jse3.log(jse3.compose(
            jnp.asarray(got.poses[i].numpy()), jse3.inverse(want.poses[i])))))
        assert err < 1e-3, (i, err)
        true_err = float(jnp.linalg.norm(jse3.log(jse3.compose(
            jnp.asarray(got.poses[i].numpy()), jse3.inverse(jnp.asarray(T_cw[i]))))))
        assert true_err < 5e-3, (i, true_err)
    np.testing.assert_allclose(got.velocities.numpy(), np.asarray(want.velocities), atol=1e-3)
    np.testing.assert_allclose(got.bg.numpy(), np.asarray(want.bg), atol=1e-3)
    np.testing.assert_allclose(got.ba.numpy(), np.asarray(want.ba), atol=1e-3)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-3)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
