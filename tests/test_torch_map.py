"""The port's MapState updates against the JAX package's, on the CPU: the
same keyframes, landmarks and associations go through both, and every map
field is compared (integers and masks exactly, floats within 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.frontend.extractor import FrameFeatures as JFeatures
from multi_orbslam3_tpu.geometry import camera as jcam
from multi_orbslam3_tpu.geometry import se3 as jse3
from multi_orbslam3_tpu.map import mapstate as jms
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.geometry import camera as tcam
from multi_orbslam3_tpu_torch.map import mapstate as tms

K_KF, P, N = 6, 96, 32


def jax_np(m):
    return {f: np.asarray(getattr(m, f)) for f in jms.MapState._fields}


def assert_maps_match(m_t, m_j):
    got, want = interop.map_to_numpy(m_t), jax_np(m_j)
    for f in want:
        if want[f].dtype.kind == "f":
            np.testing.assert_allclose(got[f], want[f], atol=1e-5, rtol=1e-5,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def features(rng):
    d = {"uv": rng.uniform(0, 300, (N, 2)).astype(np.float32),
         "response": rng.uniform(0, 50, N).astype(np.float32),
         "level": rng.randint(0, 4, N).astype(np.int32),
         "angle": rng.uniform(-3, 3, N).astype(np.float32),
         "desc": rng.randint(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32),
         "valid": rng.rand(N) < 0.9}
    d["uv_und"] = d["uv"] + 0.5
    return d


@pytest.fixture(scope="module")
def built():
    """Three keyframes and two landmark batches, inserted in both."""
    rng = np.random.RandomState(0)
    mj = jms.empty_map(K_KF, P, N)
    mt = tms.empty_map(K_KF, P, N)
    cam4 = np.array([400.0, 400.0, 160.0, 120.0], np.float32)
    poses = [np.array(jse3.exp(jnp.asarray([0.0, 0.02 * i, 0.0, 0.2 * i, 0.0, 0.1 * i])))
             for i in range(3)]
    feats = [features(rng) for _ in range(3)]
    for i in range(3):
        assoc = np.full(N, -1, np.int32)
        f = feats[i]
        mj, kj = jms.add_keyframe(mj, JFeatures(**{k: jnp.asarray(v) for k, v in f.items()}),
                                  jnp.asarray(poses[i]), 0.1 * i, jnp.asarray(assoc),
                                  i - 1, 0, cam4=jnp.asarray(cam4))
        mt, kt = tms.add_keyframe(mt, interop.features_from_numpy(f), torch.from_numpy(poses[i]),
                                  0.1 * i, torch.from_numpy(assoc), i - 1, 0,
                                  cam4=torch.from_numpy(cam4))
        assert int(kt) == int(kj) == i
    for kf_a, kf_b, B in ((1, 0, N), (2, 1, N)):
        pos = rng.uniform(-2, 2, (B, 3)).astype(np.float32) + [0, 0, 5]
        ok = rng.rand(B) < 0.7
        feat_a = np.arange(B, dtype=np.int32)
        feat_b = rng.permutation(N)[:B].astype(np.int32)
        desc = feats[kf_a]["desc"]
        mj, sj = jms.add_mappoints(mj, jnp.asarray(pos), jnp.asarray(ok), jnp.asarray(desc),
                                   kf_a, kf_a, jnp.asarray(feat_a), kf_b, jnp.asarray(feat_b))
        mt, st = tms.add_mappoints(mt, torch.from_numpy(pos), torch.from_numpy(ok),
                                   torch.from_numpy(desc.view(np.int32)), kf_a, kf_a,
                                   torch.from_numpy(feat_a), kf_b, torch.from_numpy(feat_b))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    return mt, mj


def test_add_keyframe_and_mappoints_match_jax(built):
    mt, mj = built
    assert_maps_match(mt, mj)
    assert int(mt.n_mp) > 20


def test_keyframe_insert_past_capacity_is_refused():
    rng = np.random.RandomState(1)
    mt = tms.empty_map(1, P, N)
    f = interop.features_from_numpy(features(rng))
    assoc = torch.full((N,), -1, dtype=torch.int32)
    mt, k0 = tms.add_keyframe(mt, f, torch.eye(4), 0.0, assoc, -1)
    mt2, k1 = tms.add_keyframe(mt, f, 2 * torch.eye(4), 1.0, assoc, 0)
    assert (int(k0), int(k1)) == (0, -1)
    assert torch.equal(mt2.kf_pose, mt.kf_pose) and int(mt2.n_kf) == 1


def test_covisibility_row_matches_jax(built):
    mt, mj = built
    for kf in range(3):
        np.testing.assert_array_equal(tms.covisibility_row(mt, kf).numpy(),
                                      np.asarray(jms.covisibility_row(mj, jnp.int32(kf))))


def test_update_found_visible_matches_jax(built):
    mt, mj = built
    rng = np.random.RandomState(2)
    feat_mp = np.where(rng.rand(N) < 0.6, rng.randint(0, int(mt.n_mp), N), -1).astype(np.int32)
    visible = rng.rand(P) < 0.5
    assert_maps_match(tms.update_found_visible(mt, torch.from_numpy(feat_mp),
                                               torch.from_numpy(visible)),
                      jms.update_found_visible(mj, jnp.asarray(feat_mp), jnp.asarray(visible)))


def test_refresh_point_stats_matches_jax(built):
    mt, mj = built
    slots = np.array([2, 1, 0, 0], np.int32)
    ok = np.array([True, True, True, False])
    assert_maps_match(
        tms.refresh_point_stats(mt, torch.from_numpy(slots), torch.from_numpy(ok),
                                scale_factor=1.2, n_levels=4),
        jms.refresh_point_stats(mj, jnp.asarray(slots), jnp.asarray(ok),
                                scale_factor=1.2, n_levels=4))


def test_replace_mappoint_matches_jax(built):
    mt, mj = built
    old = np.array([3, 5, -1, 9], np.int32)
    new = np.array([4, 6, 7, -1], np.int32)
    # the JAX version donates its map: hand it a copy
    mj_copy = jms.MapState(*[jnp.array(x) for x in mj])
    assert_maps_match(tms.replace_mappoint(mt, torch.from_numpy(old), torch.from_numpy(new)),
                      jms.replace_mappoint(mj_copy, jnp.asarray(old), jnp.asarray(new)))


def test_atlas_switch_and_erase_match_jax(built):
    mt, mj = built
    mt2, mj2 = tms.switch_map(mt, 1), jms.switch_map(mj, 1)
    assert_maps_match(mt2, mj2)
    assert_maps_match(tms.erase_active_map(mt), jms.erase_active_map(mj))
    assert_maps_match(tms.erase_active_map(mt2), jms.erase_active_map(mj2))


def test_kf_intrinsics_matches_jax(built):
    mt, mj = built
    Kd_t = tcam.PinholeK(*[torch.tensor(v) for v in (300.0, 310.0, 150.0, 110.0)])
    Kd_j = jcam.PinholeK(*[jnp.float32(v) for v in (300.0, 310.0, 150.0, 110.0)])
    slots = np.array([0, 2, 4, 5], np.int32)     # 4 and 5 use the default
    got = tms.kf_intrinsics(mt, torch.from_numpy(slots).long(), Kd_t)
    want = jms.kf_intrinsics(mj, jnp.asarray(slots), Kd_j)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_updates_leave_the_input_map_untouched(built):
    """Functional updates: the old map is still referenced by the fused
    step and the deferred mapping chain."""
    mt, _ = built
    before = interop.map_to_numpy(mt)
    tms.replace_mappoint(mt, torch.tensor([3]), torch.tensor([4]))
    tms.update_found_visible(mt, torch.zeros(N, dtype=torch.int32),
                             torch.ones(P, dtype=torch.bool))
    tms.erase_active_map(mt)
    after = interop.map_to_numpy(mt)
    for f in before:
        np.testing.assert_array_equal(after[f], before[f], err_msg=f)


def test_interop_round_trip_keeps_uint32_words(built):
    _, mj = built
    d = jax_np(mj)
    back = interop.map_to_numpy(interop.map_from_numpy(d))
    for f in d:
        assert back[f].dtype == d[f].dtype, f
        np.testing.assert_array_equal(back[f], d[f], err_msg=f)
