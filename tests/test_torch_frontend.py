"""Front end of the PyTorch port (pyramid, ORB, extraction, matcher)
against the JAX package, on the CPU, from the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu import config as cfg
from multi_orbslam3_tpu.dataio import synthetic
from multi_orbslam3_tpu.frontend import extractor as jex
from multi_orbslam3_tpu.frontend import fast as jfast
from multi_orbslam3_tpu.frontend import matcher as jm
from multi_orbslam3_tpu.frontend import orb as jorb
from multi_orbslam3_tpu.frontend import pyramid as jpyr
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.frontend import extractor as tex
from multi_orbslam3_tpu_torch.frontend import kernels
from multi_orbslam3_tpu_torch.frontend import matcher as tm
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch.frontend import orb as torb
from multi_orbslam3_tpu_torch.frontend import pyramid as tpyr


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frames():
    c = cfg.small_synthetic()
    seq = synthetic.make_sequence(c, n_frames=6, n_points=500, seed=7,
                                  trajectory="forward")
    imgs = np.clip(np.round(seq.images), 0, 255).astype(np.uint8)
    feats_j = [jex.extract_features(jnp.asarray(imgs[i], jnp.float32), c)
               for i in (0, 5)]
    ct = tcfg.small_synthetic()
    feats_t = [tex.extract_features(t(imgs[i]), ct) for i in (0, 5)]
    return c, imgs, feats_j, feats_t


def test_pyramid_levels_within_1e_2():
    """Level 0 is the input; levels >= 1 within 1e-2 grey levels (the two
    frameworks' antialiased bilinear weights differ in the last bits)."""
    rng = np.random.RandomState(0)
    img = np.round(rng.uniform(0, 255, (480, 752))).astype(np.float32)
    lj = jpyr.build_pyramid(jnp.asarray(img), 8, 1.2)
    lt = tpyr.build_pyramid(t(img), 8, 1.2)
    assert [tuple(a.shape) for a in lj] == [tuple(b.shape) for b in lt]
    np.testing.assert_array_equal(lt[0].numpy(), img)
    for a, b in zip(lj[1:], lt[1:]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-2, rtol=0)


def test_gaussian_blur_within_1e_4():
    rng = np.random.RandomState(1)
    img = rng.uniform(0, 255, (60, 90)).astype(np.float32)
    want = np.asarray(jpyr.gaussian_blur(jnp.asarray(img)))
    got = tpyr.gaussian_blur(t(img)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_select_level_keypoints_breaks_ties_by_lower_index():
    """Exact: a score map that is mostly ties; uv and scores equal JAX's
    lax.top_k order (lower index first)."""
    rng = np.random.RandomState(2)
    score = np.zeros((100, 140), np.float32)
    score[rng.rand(100, 140) < 0.05] = 7.0
    score[rng.rand(100, 140) < 0.01] = 9.0
    uv_j, v_j = jex._select_level_keypoints(jnp.asarray(score), 150, 32, 4)
    uv_t, v_t = tex.select_level_keypoints(t(score), 150, 32, 4)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))


def test_ic_angle_and_descriptors_match_jax():
    """Angles within 1e-4 rad; descriptors bit-identical at the same
    keypoints and angles."""
    rng = np.random.RandomState(3)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    uv = np.stack([rng.randint(20, 140, 64), rng.randint(20, 100, 64)],
                  1).astype(np.float32)
    ang_j = np.asarray(jorb.ic_angle(jnp.asarray(img), jnp.asarray(uv)))
    ang_t = torb.ic_angle(t(img), t(uv)).numpy()
    np.testing.assert_allclose(ang_t, ang_j, atol=1e-4)
    blur = np.asarray(jpyr.gaussian_blur(jnp.asarray(img)))
    d_j = np.asarray(jorb.compute_descriptors(jnp.asarray(blur), jnp.asarray(uv),
                                              jnp.asarray(ang_j)))
    d_t = torb.compute_descriptors(t(blur), t(uv), t(ang_j)).numpy()
    np.testing.assert_array_equal(d_t.view(np.uint32), d_j)


def test_extraction_matches_jax(frames):
    """Level-0 FAST scores exact; >= 95% of valid keypoints shared at the
    same (uv, level); >= 99% of shared keypoints' descriptors identical.
    Measured on this frame: 100% shared, 100% identical."""
    c, imgs, feats_j, feats_t = frames
    img = imgs[0].astype(np.float32)
    s_j = np.asarray(jfast.nms3x3(jfast.fast_score(jnp.asarray(img), 7.0)))
    s_t = kernels.fast_score_nms(t(img), 7.0).numpy()
    np.testing.assert_array_equal(s_t, s_j)

    fj = {k: np.asarray(v) for k, v in feats_j[0]._asdict().items()}
    ft = interop.features_to_numpy(feats_t[0])
    key_j = {(float(u), float(v), int(lv)): i for i, ((u, v), lv, ok) in
             enumerate(zip(fj["uv"], fj["level"], fj["valid"])) if ok}
    key_t = {(float(u), float(v), int(lv)): i for i, ((u, v), lv, ok) in
             enumerate(zip(ft["uv"], ft["level"], ft["valid"])) if ok}
    shared = set(key_j) & set(key_t)
    assert len(key_j) > 100
    assert len(shared) >= 0.95 * len(key_j)
    same = sum(np.array_equal(fj["desc"][key_j[k]], ft["desc"][key_t[k]])
               for k in shared)
    assert same >= 0.99 * len(shared)
    np.testing.assert_allclose(ft["uv_und"], fj["uv_und"], atol=1e-3)


def test_hamming_and_mutual_matching_match_jax(frames):
    """Exact: distance matrix and mutual matches between two frames, fed
    the JAX package's features."""
    c, imgs, feats_j, _ = frames
    f0, f1 = feats_j
    t0, t1 = (interop.features_from_numpy({k: np.asarray(v) for k, v in
                                           f._asdict().items()}) for f in (f0, f1))
    np.testing.assert_array_equal(
        tm.hamming_matrix(t0.desc, t1.desc).numpy(),
        np.asarray(jm.hamming_matrix(f0.desc, f1.desc)))
    for ratio, angles in ((0.9, True), (0.8, False)):
        kw_j = dict(angle1=f0.angle, angle2=f1.angle) if angles else {}
        kw_t = dict(angle1=t0.angle, angle2=t1.angle) if angles else {}
        rj = jm.match_mutual(f0.desc, f0.valid, f1.desc, f1.valid,
                             max_dist=50, ratio=ratio, **kw_j)
        rt = tm.match_mutual(t0.desc, t0.valid, t1.desc, t1.valid,
                             max_dist=50, ratio=ratio, **kw_t)
        assert int(rt.count) == int(rj.count) > 20
        np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
        np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))


def test_match_by_projection_and_duplicates_match_jax():
    """Exact: guided search with per-row radii and level windows, then the
    one-to-one resolution, on random descriptors with planted near
    duplicates and ties."""
    rng = np.random.RandomState(4)
    M, N = 300, 120
    feat_desc = rng.randint(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    src = rng.randint(0, N, M)
    mp_desc = feat_desc[src].copy()
    flip = rng.rand(M, 8) < 0.3
    mp_desc ^= (flip * (1 << rng.randint(0, 32, (M, 8)))).astype(np.uint32)
    feat_uv = rng.uniform(0, 100, (N, 2)).astype(np.float32)
    proj_uv = (feat_uv[src] + rng.normal(0, 2, (M, 2))).astype(np.float32)
    proj_valid = rng.rand(M) < 0.9
    feat_valid = rng.rand(N) < 0.95
    feat_level = rng.randint(0, 4, N).astype(np.int32)
    pred_level = rng.randint(0, 4, M).astype(np.int32)
    radius = rng.uniform(2, 10, M).astype(np.float32)
    rj = jm.match_by_projection(
        jnp.asarray(proj_uv), jnp.asarray(proj_valid), jnp.asarray(mp_desc),
        jnp.asarray(feat_uv), jnp.asarray(feat_valid), jnp.asarray(feat_desc),
        jnp.asarray(feat_level), jnp.asarray(radius), jnp.asarray(pred_level),
        max_dist=100, ratio=0.9, level_slack=1)
    rt = tm.match_by_projection(
        t(proj_uv), t(proj_valid), t(mp_desc.view(np.int32)), t(feat_uv),
        t(feat_valid), t(feat_desc.view(np.int32)), t(feat_level), t(radius),
        t(pred_level), max_dist=100, ratio=0.9, level_slack=1)
    np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
    np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))
    assert int(rt.count) > 50
    dj = jm.resolve_duplicate_targets(rj, N)
    dt = tm.resolve_duplicate_targets(rt, N)
    assert int(dt.count) < int(rt.count)       # duplicates were resolved
    np.testing.assert_array_equal(dt.idx.numpy(), np.asarray(dj.idx))
    np.testing.assert_array_equal(dt.dist.numpy(), np.asarray(dj.dist))


def test_rotation_consistency_matches_jax():
    """Exact: histogram bins with tied counts keep the lower bins first."""
    rng = np.random.RandomState(5)
    diff = np.concatenate([rng.uniform(-7, 7, 200),
                           np.full(20, 0.5), np.full(20, 2.0), np.full(20, 4.0),
                           np.full(20, 5.0)]).astype(np.float32)
    valid = rng.rand(diff.shape[0]) < 0.9
    want = np.asarray(jm.rotation_consistency(jnp.asarray(diff), jnp.asarray(valid)))
    got = tm.rotation_consistency(t(diff), t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
