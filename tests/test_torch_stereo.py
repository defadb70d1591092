"""The stereo and RGB-D slice of the PyTorch port against the JAX package,
on the CPU at tests/test_stereo.py's small configuration (320x240, 256
features, 4 levels, baseline 0.2):

(a) the plain version of the fused stereo match against the JAX masked
    matrix + best-two, exact, on random features and on tie and
    on-the-tolerance cases;
(b) stereo_match and rgbd_depth on the features of a rendered pair;
(c) pose optimisation, local BA, tracking and the mapping chain with the
    stereo rows (u_r, bf), and unchanged without them;
(d) extract_features_pair against two single extractions, bit for bit;
(e) the fused stereo step and StereoSlam's first frame against JAX;
(f) the port's StereoSlam / RGBDSlam end to end with the JAX tests' gates;
(g) one test for each hook that MonoSlam gained for these modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu import config as jcfg
from multi_orbslam3_tpu.dataio import synthetic as jsynthetic
from multi_orbslam3_tpu.frontend import extractor as jex
from multi_orbslam3_tpu.frontend import matcher as jmatcher
from multi_orbslam3_tpu.frontend import stereo as jstereo
from multi_orbslam3_tpu.geometry import camera as jcam
from multi_orbslam3_tpu.geometry import se3 as jse3
from multi_orbslam3_tpu.map import mapstate as jms
from multi_orbslam3_tpu.opt import local_ba as jlba
from multi_orbslam3_tpu.opt import pose_opt as jpo
from multi_orbslam3_tpu.pipeline import local_mapping as jlm
from multi_orbslam3_tpu.pipeline import stereo_system as jss
from multi_orbslam3_tpu.pipeline import tracking as jtr
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.eval import ate
from multi_orbslam3_tpu_torch.frontend import extractor as tex
from multi_orbslam3_tpu_torch.frontend import kernels
from multi_orbslam3_tpu_torch.frontend import stereo as tstereo
from multi_orbslam3_tpu_torch.geometry import camera as tcam
from multi_orbslam3_tpu_torch.opt import local_ba as tlba
from multi_orbslam3_tpu_torch.opt import pose_opt as tpo
from multi_orbslam3_tpu_torch.opt import robust as trobust
from multi_orbslam3_tpu_torch.pipeline import local_mapping as tlm
from multi_orbslam3_tpu_torch.pipeline import loop_closing as tlc
from multi_orbslam3_tpu_torch.pipeline import stereo_system as tss
from multi_orbslam3_tpu_torch.pipeline import system as tsys
from multi_orbslam3_tpu_torch.pipeline import tracking as ttr

# several test processes share the machine's cores; torch's intra-op pool
# spinning on all of them makes the many small ops here wait on each other
torch.set_num_threads(2)

BIG = 10_000


def stereo_config(cfg):
    c = cfg.synthetic_mono(width=320, height=240)
    return c.replace(
        sensor="stereo",
        camera=cfg.CameraConfig(width=320, height=240, fx=400.0, fy=400.0,
                                cx=160.0, cy=120.0, baseline=0.2),
        orb=cfg.ORBConfig(n_features=256, n_levels=4),
        map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                          max_obs_per_kf=256),
        local_mapping=cfg.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                             local_ba_points=1024,
                                             local_ba_iters=8))


# each package gets a config object of its own, built from the same values
CJ = stereo_config(jcfg)
CT = stereo_config(tcfg)
BF = CT.camera.baseline * CT.camera.fx


def t(a):
    return torch.from_numpy(np.array(a))


def jax_np(x):
    return {f: np.array(getattr(x, f)) for f in x._fields}


@pytest.fixture(scope="module")
def seq():
    return jsynthetic.make_sequence(CJ, n_frames=30, n_points=500, seed=9,
                                    trajectory="forward")


# ----------------------------------------------------------------------
# (a) the fused stereo match's plain version
# ----------------------------------------------------------------------

def _jax_stereo_best_two(descL, uvL, validL, levelL, descR, uvR, validR, levelR,
                         row_tol=2.0, max_disparity=128.0):
    """stereo.py's masked matrix and matcher._best_two, spelled out."""
    dv = jnp.abs(uvL[:, None, 1] - uvR[None, :, 1])
    disp = uvL[:, None, 0] - uvR[None, :, 0]
    lv_ok = jnp.abs(levelL[:, None] - levelR[None, :]) <= 1
    tol = row_tol * jnp.power(1.2, levelL.astype(jnp.float32))
    mask = (dv <= tol[:, None]) & (disp > 0.3) & (disp < max_disparity) \
        & lv_ok & validL[:, None] & validR[None, :]
    dist = jnp.where(mask, jmatcher.hamming_matrix(descL, descR), jmatcher.BIG)
    return jmatcher._best_two(dist), tol, mask


def _check_stereo_case(descL, uvL, validL, levelL, descR, uvR, validR, levelR,
                       min_unmasked=1):
    (idx_j, best_j, second_j), tol_j, mask = _jax_stereo_best_two(
        jnp.asarray(descL), jnp.asarray(uvL), jnp.asarray(validL),
        jnp.asarray(levelL), jnp.asarray(descR), jnp.asarray(uvR),
        jnp.asarray(validR), jnp.asarray(levelR))
    assert int(mask.sum()) >= min_unmasked
    tol = kernels.stereo_row_tolerance(t(levelL), 2.0)
    np.testing.assert_array_equal(tol.numpy(), np.asarray(tol_j))
    idx, best, second = kernels.hamming_best_two_stereo(
        t(descL.view(np.int32)), t(uvL), t(validL), t(levelL), tol,
        t(descR.view(np.int32)), t(uvR), t(validR), t(levelR), 128.0)
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_j))
    np.testing.assert_array_equal(second.numpy(), np.asarray(second_j))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    return mask


def _random_stereo_features(seed, n=200, m=180, n_levels=8):
    rng = np.random.RandomState(seed)
    descR = rng.randint(0, 2 ** 32, (m, 8), dtype=np.uint64).astype(np.uint32)
    src = rng.randint(0, m, n)
    descL = descR[src] ^ (np.uint32(1) << rng.randint(0, 32, (n, 8)).astype(np.uint32))
    uvR = np.stack([rng.uniform(0, 300, m), rng.uniform(0, 240, m)], 1)
    levelR = rng.randint(0, n_levels, m)
    uvL = uvR[src] + np.stack([rng.uniform(-5, 90, n), rng.randn(n) * 2.5], 1)
    levelL = np.clip(levelR[src] + rng.randint(-2, 3, n), 0, n_levels - 1)
    f = np.float32
    return (descL, uvL.astype(f), rng.rand(n) > 0.15, levelL.astype(np.int32),
            descR, uvR.astype(f), rng.rand(m) > 0.15, levelR.astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stereo_best_two_plain_version_equals_jax_on_random_features(seed):
    mask = _check_stereo_case(*_random_stereo_features(seed), min_unmasked=50)
    assert int((~mask).sum()) > 1000


def test_stereo_best_two_plain_version_equals_jax_on_ties():
    """Duplicate right descriptors on one row: the first index wins and
    second == best; an all-masked row gives (0, BIG, BIG)."""
    descL, uvL, validL, levelL, descR, uvR, validR, levelR = \
        _random_stereo_features(3, n=64, m=48)
    descR[:] = descR[0]
    descL[:] = descR[0]
    descL[::2, 0] ^= np.uint32(0x80000001)
    uvR[:, 1] = 100.0
    uvL[:, 1] = 100.0
    uvL[:, 0] = uvR[:, 0].max() + 5.0
    uvL[7, 1] = 180.0                         # nothing on this row's line
    levelL[:] = 2
    levelR[:] = 2
    validL[:] = True
    _check_stereo_case(descL, uvL, validL, levelL, descR, uvR, validR, levelR)
    tol = kernels.stereo_row_tolerance(t(levelL), 2.0)
    idx, best, second = kernels.hamming_best_two_stereo(
        t(descL.view(np.int32)), t(uvL), t(validL), t(levelL), tol,
        t(descR.view(np.int32)), t(uvR), t(validR), t(levelR), 128.0)
    assert (idx[7], best[7], second[7]) == (0, BIG, BIG)
    ok = torch.arange(64) != 7
    assert torch.equal(best[ok], second[ok])
    disp = uvL[0, 0] - uvR[:, 0]
    first = int(np.nonzero(validR & (disp > 0.3) & (disp < 128.0))[0][0])
    assert (idx[ok] == first).all()


def test_stereo_best_two_plain_version_equals_jax_on_the_tolerance():
    """Right features exactly on the row tolerance of their level (inside),
    one float32 step beyond it (outside), at disparity exactly 0.3 and
    128 (outside), one step inside each, and at level gaps of 1 and 2."""
    n_levels = 8
    f = np.float32
    rng = np.random.RandomState(4)
    rows = []
    for lv in range(n_levels):
        tol = f(2.0) * f(np.float64(f(1.2)) ** lv)
        for dv in (tol, np.nextafter(tol, f(np.inf)), -tol,
                   np.nextafter(-tol, f(-np.inf))):
            rows.append((lv, dv, f(40.0), lv))
    for disp in (f(0.3), np.nextafter(f(0.3), f(1)), f(128.0),
                 np.nextafter(f(128.0), f(0))):
        rows.append((1, f(0.0), disp, 1))
    for gap in (1, 2, -1, -2):
        rows.append((3, f(0.0), f(40.0), 3 + gap))
    n = len(rows)
    # one left and one right feature a case. The differences under test are
    # exact in float32: a row case has vL = 0 and vR = dv, a disparity case
    # uR = 0 and uL = disp. Cases do not see each other: the first kind sit
    # 1000 px apart in u (integers, so uL - uR = 40 exactly), the second
    # kind 100 px apart in v, far from the rest.
    k = np.arange(n)
    is_disp = (k >= 4 * n_levels) & (k < 4 * n_levels + 4)
    levelL = np.array([r[0] for r in rows], np.int32)
    levelR = np.array([r[3] for r in rows], np.int32)
    dv = np.array([r[1] for r in rows], f)
    disp = np.array([r[2] for r in rows], f)
    uR = np.where(is_disp, 0.0, 1000.0 * k).astype(f)
    uL = np.where(is_disp, disp, uR + disp).astype(f)
    vL = np.where(is_disp, 5000.0 + 100.0 * k, 0.0).astype(f)
    vR = np.where(is_disp, vL, dv).astype(f)
    assert ((uL - uR) == disp).all() and ((vR - vL)[~is_disp] == dv[~is_disp]).all()
    uvL, uvR = np.stack([uL, vL], 1), np.stack([uR, vR], 1)
    desc = rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    ones = np.ones(n, bool)
    mask = np.asarray(_check_stereo_case(desc, uvL, ones, levelL, desc.copy(), uvR,
                                         ones, levelR))
    want = [True, False, True, False] * n_levels \
        + [False, True, False, True] + [True, False, True, False]
    assert list(mask[k, k]) == want
    assert mask.sum() == sum(want)            # and no case sees another


# ----------------------------------------------------------------------
# (b) stereo_match and rgbd_depth
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair_features(seq):
    fL = jex.extract_features(jnp.asarray(seq.images[0]), CJ)
    fR = jex.extract_features(jnp.asarray(seq.images_right[0]), CJ)
    return fL, fR


def test_stereo_match_equals_jax(pair_features, seq):
    """valid and the matched right feature equal; u_right and depth to
    1e-5 relative. Two right rows are moved onto the row tolerance."""
    fL, fR = pair_features
    for nudge in (False, True):
        dR = jax_np(fR)
        if nudge:
            sd0 = jstereo.stereo_match(fL, fR, jnp.float32(BF))
            rows = np.nonzero(np.asarray(sd0.valid))[0][:2]
            uvL, lvL = np.asarray(fL.uv_und), np.asarray(fL.level)
            for i in rows:
                j = int(np.argmin(np.abs(dR["uv_und"][:, 0] - np.asarray(sd0.u_right)[i])
                                  + np.abs(dR["uv_und"][:, 1] - uvL[i, 1])))
                tol = np.float32(2.0) * np.float32(np.float64(np.float32(1.2)) ** lvL[i])
                dR["uv_und"][j, 1] = uvL[i, 1] + tol
        fRj = jex.FrameFeatures(**{k: jnp.asarray(v) for k, v in dR.items()})
        want = jstereo.stereo_match(fL, fRj, jnp.float32(BF))
        got = tstereo.stereo_match(interop.features_from_numpy(jax_np(fL)),
                                   interop.features_from_numpy(dR), BF)
        ok = np.asarray(want.valid)
        assert ok.sum() > 40
        np.testing.assert_array_equal(got.valid.numpy(), ok)
        np.testing.assert_allclose(got.u_right.numpy(), np.asarray(want.u_right),
                                   rtol=1e-5)
        np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                                   rtol=1e-5)
        d = interop.stereo_depth_to_numpy(got)
        assert set(d) == set(want._fields)
        back = interop.stereo_depth_from_numpy(d)
        assert torch.equal(back.depth, got.depth)


def test_rgbd_depth_equals_jax(pair_features, seq):
    fL, _ = pair_features
    d = jax_np(fL)
    d["uv"] = d["uv"].copy()
    d["uv"][:6, 0] += 0.5                     # half-way cases round to even
    f = jex.FrameFeatures(**{k: jnp.asarray(v) for k, v in d.items()})
    want = jstereo.rgbd_depth(f, jnp.asarray(seq.depths[0]), jnp.float32(BF))
    got = tstereo.rgbd_depth(interop.features_from_numpy(d), t(seq.depths[0]), BF)
    assert np.asarray(want.valid).sum() > 50
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-5)
    np.testing.assert_allclose(got.u_right.numpy(), np.asarray(want.u_right), rtol=1e-5)


# ----------------------------------------------------------------------
# (c) the stereo rows in the optimizers
# ----------------------------------------------------------------------

KV = (400.0, 400.0, 160.0, 120.0)


def _pose_problem(seed, n=120, stereo_frac=0.6):
    rng = np.random.RandomState(seed)
    T = np.asarray(jse3.exp(jnp.asarray(rng.randn(6) * 0.2, jnp.float32)))
    p_c = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                    rng.uniform(2, 9, n)], 1).astype(np.float32)
    p_w = np.asarray(jse3.apply(jse3.inverse(jnp.asarray(T)), jnp.asarray(p_c)))
    uv = np.stack([KV[0] * p_c[:, 0] / p_c[:, 2] + KV[2],
                   KV[1] * p_c[:, 1] / p_c[:, 2] + KV[3]], 1)
    uv = (uv + rng.randn(n, 2) * 0.7).astype(np.float32)
    u_r = (uv[:, 0] - BF / p_c[:, 2] + rng.randn(n) * 0.7).astype(np.float32)
    u_r[rng.rand(n) > stereo_frac] = -1.0
    uv[:8] += 25.0                            # gross outliers
    # stereo observations that are outliers only in the third row
    u_r[8:12] = np.abs(uv[8:12, 0] - BF / p_c[8:12, 2]) + 20.0
    inv_s2 = (1.2 ** (-2.0 * rng.randint(0, 4, n))).astype(np.float32)
    mask = rng.rand(n) > 0.1
    T0 = np.asarray(jse3.retract(jnp.asarray(T),
                                 jnp.asarray(rng.randn(6) * 0.03, jnp.float32)))
    return T, T0, p_w, uv, u_r, inv_s2, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_optimization_with_stereo_rows_equals_jax(seed):
    """Pose to 1e-4, the inlier sets equal; without u_r the result is the
    monocular one, and u_r = -1 everywhere equals u_r=None exactly."""
    T, T0, p_w, uv, u_r, inv_s2, mask = _pose_problem(seed)
    Kj = jcam.PinholeK(*[jnp.float32(x) for x in KV])
    Kt = tcam.PinholeK(*[torch.tensor(x) for x in KV])
    args_j = [jnp.asarray(x) for x in (T0, p_w, uv, inv_s2, mask)]
    args_t = [t(x) for x in (T0, p_w, uv, inv_s2, mask)]
    for ur in (u_r, None):
        want = jpo.pose_optimization(args_j[0], Kj, *args_j[1:],
                                     u_r=None if ur is None else jnp.asarray(ur),
                                     bf=BF)
        got = tpo.pose_optimization(args_t[0], Kt, *args_t[1:],
                                    u_r=None if ur is None else t(ur), bf=BF)
        np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-4)
        np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
        assert int(got.n_inliers) == int(want.n_inliers) > 60
        np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-3)
        assert np.abs(got.pose.numpy() - T).max() < 0.05
    stereo = tpo.pose_optimization(args_t[0], Kt, *args_t[1:], u_r=t(u_r), bf=BF)
    plain = tpo.pose_optimization(args_t[0], Kt, *args_t[1:])
    none = tpo.pose_optimization(args_t[0], Kt, *args_t[1:], u_r=None, bf=BF)
    mono = tpo.pose_optimization(args_t[0], Kt, *args_t[1:],
                                 u_r=torch.full((len(u_r),), -1.0), bf=BF)
    assert torch.equal(plain.pose, none.pose) and torch.equal(plain.inliers, none.inliers)
    np.testing.assert_allclose(mono.pose.numpy(), plain.pose.numpy(), atol=1e-6)
    assert torch.equal(mono.inliers, plain.inliers)
    # the third row rejects what only it can see
    assert not stereo.inliers[8:12].any() and plain.inliers[8:12].sum() >= 1
    assert trobust.CHI2_STEREO == 7.815


def _ba_problem(seed, n_kf=5, n_pts=70):
    rng = np.random.RandomState(seed)
    T = np.stack([np.asarray(jse3.exp(jnp.asarray(
        np.concatenate([rng.randn(3) * 0.03, [0.25 * i, 0.02 * i, 0.05 * i]]),
        jnp.float32))) for i in range(n_kf)])
    pts = np.stack([rng.uniform(-2, 3, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(3, 9, n_pts)], 1).astype(np.float32)
    p_c = np.einsum("kij,pj->kpi", T[:, :3, :3], pts) + T[:, None, :3, 3]
    uv = np.stack([KV[0] * p_c[..., 0] / p_c[..., 2] + KV[2],
                   KV[1] * p_c[..., 1] / p_c[..., 2] + KV[3]], -1)
    uv = (uv + rng.randn(n_kf, n_pts, 2) * 0.5).reshape(-1, 2).astype(np.float32)
    u_r = (uv[:, 0] - BF / p_c[..., 2].reshape(-1)
           + rng.randn(n_kf * n_pts) * 0.5).astype(np.float32)
    u_r[rng.rand(n_kf * n_pts) > 0.6] = -1.0
    valid = rng.rand(n_kf * n_pts) > 0.1
    uv[::31] += 20.0
    poses0 = T.copy()
    for i in range(1, n_kf):
        poses0[i] = np.asarray(jse3.retract(
            jnp.asarray(T[i]), jnp.asarray(rng.randn(6) * 0.01, jnp.float32)))
    pts0 = pts + rng.randn(n_pts, 3).astype(np.float32) * 0.03
    fixed = np.arange(n_kf) == 0
    obs = dict(kf=np.repeat(np.arange(n_kf, dtype=np.int32), n_pts),
               pt=np.tile(np.arange(n_pts, dtype=np.int32), n_kf), uv=uv,
               inv_sigma2=np.ones(n_kf * n_pts, np.float32), valid=valid)
    return T, pts, poses0, pts0, fixed, obs, u_r


def test_bundle_adjust_with_stereo_rows_equals_jax():
    """Poses and points to 1e-4, the inlier sets equal, with u_r and
    without; u_r=None gives what the function gave before it had u_r."""
    T, pts, poses0, pts0, fixed, obs, u_r = _ba_problem(0)
    Kj = jcam.PinholeK(*[jnp.float32(x) for x in KV])
    Kt = tcam.PinholeK(*[torch.tensor(x) for x in KV])
    for ur in (u_r, None):
        oj = jlba.BAObservations(**{k: jnp.asarray(v) for k, v in obs.items()},
                                 u_r=None if ur is None else jnp.asarray(ur))
        ot = tlba.BAObservations(**{k: t(v) for k, v in obs.items()},
                                 u_r=None if ur is None else t(ur))
        want = jlba.bundle_adjust(jnp.asarray(poses0), jnp.asarray(fixed),
                                  jnp.asarray(pts0), oj, Kj, iters=8, bf=BF)
        got = tlba.bundle_adjust(t(poses0), t(fixed), t(pts0), ot, Kt, iters=8, bf=BF)
        np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=1e-4)
        np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-4)
        np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
        np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=1e-3)
    mono = tlba.BAObservations(**{k: t(v) for k, v in obs.items()})
    assert mono.u_r is None
    a = tlba.bundle_adjust(t(poses0), t(fixed), t(pts0), mono, Kt, iters=8)
    b = tlba.bundle_adjust(t(poses0), t(fixed), t(pts0), mono, Kt, iters=8, bf=BF)
    assert torch.equal(a.poses, b.poses) and torch.equal(a.points, b.points)


# ----------------------------------------------------------------------
# (d) one K1 launch for both images
# ----------------------------------------------------------------------

def test_extract_features_pair_equals_two_single_extractions(seq):
    il, ir = t(seq.images[3]), t(seq.images_right[3])
    fl, fr = tex.extract_features_pair(il, ir, CT)
    for got, img in ((fl, il), (fr, ir)):
        want = tex.extract_features(img, CT)
        for name in want._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert 2 * CT.orb.n_levels <= kernels.MAX_LEVELS
    big = tcfg.euroc_mono() if hasattr(tcfg, "euroc_mono") else tcfg.SystemConfig()
    assert 2 * big.orb.n_levels <= kernels.MAX_LEVELS


# ----------------------------------------------------------------------
# (e) the fused stereo step and the first frame, against JAX
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def first_frame(seq):
    """Both packages' StereoSlam after frame 0 (the depth-seeded map)."""
    sj = jss.StereoSlam(CJ, enable_loop_closing=False)
    st = tss.StereoSlam(CT, enable_loop_closing=False, device="cpu")
    sj.process_frame_stereo(seq.images[0], seq.images_right[0], float(seq.timestamps[0]))
    st.process_frame_stereo(seq.images[0], seq.images_right[0], float(seq.timestamps[0]))
    return sj, st


def test_stereo_first_frame_map_equals_jax(first_frame):
    """No random draw in the depth initialisation: keyframe 0 at the
    identity, the same landmark set, positions to 1e-5 relative, the same
    right-u row and observations."""
    sj, st = first_frame
    assert st.state == tsys.TrackState.OK and sj.state.name == "OK"
    mj, mt = jax_np(sj.m), interop.map_to_numpy(st.m)
    assert int(mt["n_kf"]) == int(mj["n_kf"]) == 1
    assert int(mt["n_mp"]) == int(mj["n_mp"]) > 50
    np.testing.assert_array_equal(mt["kf_pose"][0], np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(mt["mp_valid"], mj["mp_valid"])
    np.testing.assert_array_equal(mt["kf_mp"][0], mj["kf_mp"][0])
    np.testing.assert_array_equal(mt["mp_desc"], mj["mp_desc"])
    np.testing.assert_allclose(mt["mp_pos"], mj["mp_pos"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mt["kf_ur"][0], mj["kf_ur"][0], rtol=1e-5)
    assert st.stats["mp_created"] == sj.stats["mp_created"]


def test_fused_step_stereo_chained_equals_jax(first_frame, seq):
    """One frame on the JAX system's map: packed (pose, counts, T_pred) to
    1e-4 (the counts equal), the stereo depth and feat_mp agreeing on
    >= 98% of the features."""
    sj, _ = first_frame
    imgs = [np.clip(np.round(x[1]), 0, 255).astype(np.uint8)
            for x in (seq.images, seq.images_right)]
    T_cur = np.eye(4, dtype=np.float32)
    T_vel = (seq.T_cw[1] @ np.linalg.inv(seq.T_cw[0])).astype(np.float32)
    fj, sdj, rj, pose_j, vel_j = jtr._fused_step_stereo_chained(CJ)(
        sj.m, jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), jnp.asarray(T_cur),
        jnp.asarray(T_vel))
    mt = interop.map_from_numpy(jax_np(sj.m))
    ft, sdt, rt, pose_t, vel_t = ttr.fused_step_stereo_chained(
        CT, mt, t(imgs[0]), t(imgs[1]), t(T_cur), t(T_vel))
    assert int(rj.n_inliers) > 40
    assert rt.packed.shape == (34,)
    np.testing.assert_allclose(rt.packed.numpy(), np.asarray(rj.packed), atol=1e-4)
    np.testing.assert_allclose(pose_t.numpy(), np.asarray(pose_j), atol=1e-4)
    np.testing.assert_allclose(vel_t.numpy(), np.asarray(vel_j), atol=1e-4)
    # the two extractors' pyramids differ by ~1e-3 grey levels above level
    # 0, which can flip a descriptor bit: the stereo depth agrees on >= 98%
    # of the features and exactly where both matched
    both = sdt.valid.numpy() & np.asarray(sdj.valid)
    assert np.mean(sdt.valid.numpy() == np.asarray(sdj.valid)) >= 0.98
    assert np.mean(np.isclose(sdt.u_right.numpy()[both], np.asarray(sdj.u_right)[both],
                              rtol=1e-5)) >= 0.98
    assert np.mean(rt.feat_mp.numpy() == np.asarray(rj.feat_mp)) >= 0.98
    # the map's gauge is frame 0: T_vel is also the true pose of frame 1
    assert np.abs(pose_t.numpy() - T_vel).max() < 0.05


def test_track_frame_and_map_keyframe_with_stereo_rows_equal_jax(first_frame, seq):
    """track_frame with u_r/bf on the JAX map: pose to 1e-4, the same
    associations; then a keyframe and the mapping chain with bf on both:
    keyframe poses to 1e-3, counts within 10%. Without u_r both give the
    monocular result."""
    sj, _ = first_frame
    Kj = jcam.intrinsics_from_config(CJ.camera)
    Kt = tcam.intrinsics_from_config(CT.camera)
    fLj = jex.extract_features(jnp.asarray(seq.images[2]), CJ)
    fRj = jex.extract_features(jnp.asarray(seq.images_right[2]), CJ)
    sdj = jstereo.stereo_match(fLj, fRj, jnp.float32(BF))
    ft = interop.features_from_numpy(jax_np(fLj))
    mt = interop.map_from_numpy(jax_np(sj.m))
    T_pred = seq.T_cw[2].astype(np.float32)
    kw = dict(width=320, height=240, scale_factor=CT.orb.scale_factor,
              n_levels=CT.orb.n_levels, radius_coarse=CT.tracking.search_radius)
    for ur in (np.asarray(sdj.u_right), None):
        want = jtr.track_frame(sj.m, fLj, jnp.asarray(T_pred), Kj, **kw,
                               u_r=None if ur is None else jnp.asarray(ur), bf=BF)
        got = ttr.track_frame(mt, ft, t(T_pred), Kt, **kw,
                              u_r=None if ur is None else t(ur), bf=BF)
        np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-4)
        np.testing.assert_array_equal(got.feat_mp.numpy(), np.asarray(want.feat_mp))
        assert int(got.n_inliers) == int(want.n_inliers) > 40
    mj, k = jms.add_keyframe(sj.m, fLj, want.pose, float(seq.timestamps[2]),
                             want.feat_mp, 0, u_r=sdj.u_right)
    mt = interop.map_from_numpy(jax_np(mj))
    mkw = tlm.mapping_kwargs(CT)
    out_j = jlm.map_keyframe(mj, k, Kj, **mkw, bf=BF)
    out_t = tlm.map_keyframe(mt, int(k), Kt, **mkw, bf=BF)
    for name in ("n_created", "n_fused"):
        a, b = int(getattr(out_t, name)), int(getattr(out_j, name))
        assert abs(a - b) <= 0.1 * b + 1, (name, a, b)
    np.testing.assert_allclose(out_t.map.kf_pose[:2].numpy(),
                               np.asarray(out_j.map.kf_pose[:2]), atol=1e-3)
    np.testing.assert_allclose(float(out_t.chi2), float(out_j.chi2), rtol=0.05)
    # bf = 0 leaves the stereo rows out: a monocular map gives the same
    mono_a = tlm.map_keyframe(mt._replace(kf_ur=torch.full_like(mt.kf_ur, -1.0)),
                              int(k), Kt, **mkw)
    mono_b = tlm.map_keyframe(mt, int(k), Kt, **mkw)
    assert torch.equal(mono_a.map.kf_pose, mono_b.map.kf_pose)


# ----------------------------------------------------------------------
# (f) end to end, the gates of tests/test_stereo.py
# ----------------------------------------------------------------------

def _metric_ate(slam, seq):
    est = np.stack([T for _, T in slam.trajectory])
    e = ate.camera_centers(est)
    g = ate.camera_centers(seq.T_cw[:len(est)])
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    return ate.ate_rmse(e, g, with_scale=False), span, ate.umeyama_align(e, g)[0]


@pytest.mark.parametrize("pipelined", [False, True])
def test_stereo_slam_metric_scale(seq, pipelined):
    """State OK, > 20 tracked, ATE without scale alignment < 0.08 x span,
    Umeyama scale within 0.35 of 1. Measured on the CPU: ATE 0.042 / 0.050 m
    over 2.36 m, scale 1.004 / 1.000."""
    slam = tss.StereoSlam(CT, enable_loop_closing=False, device="cpu")
    step = slam.process_frame_stereo_pipelined if pipelined else slam.process_frame_stereo
    for i in range(seq.images.shape[0]):
        step(seq.images[i], seq.images_right[i], float(seq.timestamps[i]))
    slam.finish()
    assert slam.state == tsys.TrackState.OK
    assert slam.stats["frames_tracked"] > 20
    assert len(slam.trajectory) == 30
    rmse, span, s = _metric_ate(slam, seq)
    assert rmse < 0.08 * span, f"metric ATE {rmse:.3f} span {span:.2f}"
    assert abs(s - 1.0) < 0.35, f"scale {s}"
    n = int(slam.m.n_kf)
    assert n >= 3 and bool((slam.m.kf_ur[:n] >= 0).any(dim=1).all())


def test_rgbd_slam(seq):
    """State OK, > 12 of 20 tracked (tests/test_stereo.py's gate), and the
    metric ATE gate of the stereo run."""
    slam = tss.RGBDSlam(CT.replace(sensor="rgbd"), enable_loop_closing=False,
                        device="cpu")
    for i in range(20):
        slam.process_frame_rgbd(seq.images[i], seq.depths[i], float(seq.timestamps[i]))
    assert slam.state == tsys.TrackState.OK
    assert slam.stats["frames_tracked"] > 12
    rmse, span, _ = _metric_ate(slam, seq)
    assert rmse < 0.08 * span


# ----------------------------------------------------------------------
# (g) the hooks MonoSlam gained
# ----------------------------------------------------------------------

def test_new_systems_default_to_the_card_and_raise_without_one():
    from multi_orbslam3_tpu_torch import pipeline
    for name in ("StereoSlam", "RGBDSlam", "MonoInertialSlam", "StereoInertialSlam",
                 "RGBDInertialSlam"):
        cls = getattr(pipeline, name)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match='device="cpu"'):
                cls(CT, enable_loop_closing=False)
        assert cls(CT, enable_loop_closing=False, device="cpu").device.type == "cpu"


class _Spy(tss.StereoSlam):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = []

    def _pre_track(self, ts):
        self.calls.append(("pre", self.frame_id))

    def _post_track(self, ts):
        self.calls.append(("post", self.frame_id))

    def _refine_pose(self, feats, res):
        self.calls.append(("refine", self.frame_id))
        return super()._refine_pose(feats, res)

    def _seed_depth_points(self, k, feats):
        self.calls.append(("seed", k, int(self.m.n_kf), self._pending_map is None))
        super()._seed_depth_points(k, feats)


def test_repair_hooks_run_around_tracking_in_both_synchronous_loops(seq):
    """_pre_track before and _post_track after every tracked frame, in
    MonoSlam._process_frame and in the depth loop; _refine_pose on every
    frame that tracks; _seed_depth_points after the keyframe exists and
    before its mapping chain is dispatched."""
    slam = _Spy(CT, enable_loop_closing=False, device="cpu")
    for i in range(8):
        slam.process_frame_stereo(seq.images[i], seq.images_right[i],
                                  float(seq.timestamps[i]))
    for i in range(8, 10):                    # the monocular entry point
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
    frames = list(range(1, 10))
    assert [c[1] for c in slam.calls if c[0] == "pre"] == frames
    assert [c[1] for c in slam.calls if c[0] == "post"] == frames
    assert [c[1] for c in slam.calls if c[0] == "refine"] == frames
    order = [c[0] for c in slam.calls if c[0] != "seed"]
    assert order == ["pre", "refine", "post"] * 9
    seeds = [c for c in slam.calls if c[0] == "seed"]
    assert len(seeds) == slam.stats["kf_inserted"] - 1 >= 1
    for _, k, n_kf, nothing_pending in seeds:
        assert k == n_kf - 1 and nothing_pending


def test_repair_refine_pose_hands_its_host_pose_over(seq):
    """A hook that returns another result replaces the pose, and the pose it
    leaves in _refined_pose_np is the one the state machine takes."""
    T_fake = np.eye(4, dtype=np.float32)
    T_fake[:3, 3] = [0.01, 0.02, 0.03]

    class Refiner(tss.StereoSlam):
        def _refine_pose(self, feats, res):
            self._refined_pose_np = T_fake
            return res._replace(pose=res.pose.clone())

    slam = Refiner(CT, enable_loop_closing=False, device="cpu")
    for i in range(2):
        slam.process_frame_stereo(seq.images[i], seq.images_right[i],
                                  float(seq.timestamps[i]))
    np.testing.assert_array_equal(slam.T_cur, T_fake)
    assert slam._refined_pose_np is None


def test_repair_keyframes_carry_right_u_and_depth_points_and_bf_reaches_mapping(seq, monkeypatch):
    seen = []
    real = tlm.map_keyframe

    def spy(m, k, K, **kw):
        seen.append(kw.get("bf"))
        return real(m, k, K, **kw)

    monkeypatch.setattr(tlm, "map_keyframe", spy)
    slam = tss.StereoSlam(CT, enable_loop_closing=False, device="cpu")
    created = []
    for i in range(12):
        slam.process_frame_stereo(seq.images[i], seq.images_right[i],
                                  float(seq.timestamps[i]))
        created.append(slam.stats["mp_created"])
    assert seen and all(bf == pytest.approx(BF) for bf in seen)
    n = int(slam.m.n_kf)
    assert n >= 2
    ur = slam.m.kf_ur[:n]
    assert bool((ur >= 0).any(dim=1).all())           # every keyframe has right-u
    mono = tsys.MonoSlam(CT, enable_loop_closing=False, device="cpu")
    assert mono._frame_ur() is None and mono._bf() == 0.0
    assert slam._bf() == pytest.approx(BF)


def test_repair_loop_closing_keeps_the_scale_of_a_stereo_map(monkeypatch):
    """fix_scale = bf > 0 or yaw_only: a stereo map's scale is not freed at
    a loop; a monocular map's is."""
    got = {}

    def fake(self, m, k, **kw):
        got[type(self._owner).__name__] = (kw["fix_scale"], kw["yaw_only"])
        return m

    monkeypatch.setattr(tlc.LoopCloser, "on_keyframe", fake)
    from multi_orbslam3_tpu_torch.bow import vocabulary as tvoc
    voc = tvoc.default_vocabulary(6, 3, device="cpu")
    for cls in (tsys.MonoSlam, tss.StereoSlam, tss.RGBDSlam):
        slam = cls(CT, vocabulary=voc, device="cpu")
        slam.loop_closer._owner = slam
        slam._loop_close(0)
    assert got == {"MonoSlam": (False, False), "StereoSlam": (True, False),
                   "RGBDSlam": (True, False)}


def test_repair_weld_after_merge_takes_bf(first_frame):
    """weld_after_merge passes bf to its local BA, as the JAX function does."""
    import inspect
    assert inspect.signature(tlc.weld_after_merge).parameters["bf"].default == 0.0
    _, st = first_frame
    a = tlc.weld_after_merge(st.m, 0, st.K, width=320, height=240, n_levels=4, bf=BF)
    b = tlc.weld_after_merge(st.m, 0, st.K, width=320, height=240, n_levels=4)
    assert a.kf_pose.shape == b.kf_pose.shape
    assert bool(torch.isfinite(a.mp_pos).all())


def test_repair_pipeline_depth_is_an_attribute_of_the_system(seq):
    """As in the JAX class, the number of frames in flight is an attribute a
    caller can set: with depth 2 the pipelined stereo loop holds two
    dispatched frames back, and finish() drains them."""
    slam = tss.StereoSlam(CT, enable_loop_closing=False, device="cpu")
    assert slam.pipeline_depth == 1
    slam.pipeline_depth = 2
    for i in range(5):
        slam.process_frame_stereo_pipelined(seq.images[i], seq.images_right[i],
                                            float(seq.timestamps[i]))
    assert len(slam._pipe) == 2 and len(slam.frame_log) == 3
    slam.finish()
    assert not slam._pipe and len(slam.frame_log) == 5
