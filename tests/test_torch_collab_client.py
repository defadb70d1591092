"""The port's CollabClient against the JAX package's, on the CPU: both
clients hold the same map (built in numpy, carried to each package), so
_build_delta must produce the same uplink bytes, and the same downlink
(locked pose and landmark corrections, a merge gauge, foreign keyframes
and landmarks, refreshes, erasures and revocations) must leave both maps
and both clients' books equal (integers exactly, floats to 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu import config as jcfg
from multi_orbslam3_tpu.collab import protocol as jproto
from multi_orbslam3_tpu.collab.client import CollabClient as JClient
from multi_orbslam3_tpu.collab.transport import InProcessTransport as JTransport
from multi_orbslam3_tpu.map import mapstate as jms
from multi_orbslam3_tpu.pipeline.system import TrackState as JState
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.collab.client import CollabClient as TClient
from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport as TTransport
from multi_orbslam3_tpu_torch.pipeline.system import TrackState as TState

torch.set_num_threads(2)


def client_map(cfg, seed, n_kf=10, n_mp=300):
    """A client map at the config's capacity: keyframes along a path with
    features, associations and landmarks, as numpy arrays."""
    rng = np.random.RandomState(seed)
    K, P, N = cfg.map.max_keyframes, cfg.map.max_mappoints, cfg.orb.n_features
    d = {f: np.array(v) for f, v in
         ((f, np.asarray(getattr(jms.empty_map(K, P, N), f))) for f in jms.MapState._fields)}
    for k in range(n_kf):
        d["kf_pose"][k, :3, 3] = [0.2 * k, 0.01 * k, 0.0]
    d["kf_valid"][:n_kf] = True
    d["kf_parent"][1:n_kf] = np.arange(n_kf - 1)
    d["kf_timestamp"][:n_kf] = np.arange(n_kf) * 0.5
    d["kf_uv"][:n_kf] = rng.uniform(0, 300, (n_kf, N, 2))
    d["kf_desc"][:n_kf] = rng.randint(0, 2 ** 32, (n_kf, N, 8), dtype=np.uint64)
    d["kf_level"][:n_kf] = rng.randint(0, 4, (n_kf, N))
    d["kf_angle"][:n_kf] = rng.randn(n_kf, N)
    d["kf_feat_valid"][:n_kf] = rng.rand(n_kf, N) < 0.9
    mp = rng.randint(0, n_mp, (n_kf, N)).astype(np.int32)
    d["kf_mp"][:n_kf] = np.where(rng.rand(n_kf, N) < 0.5, mp, -1)
    d["mp_pos"][:n_mp] = rng.randn(n_mp, 3) + [0, 0, 5]
    d["mp_valid"][:n_mp] = True
    d["mp_desc"][:n_mp] = rng.randint(0, 2 ** 32, (n_mp, 8), dtype=np.uint64)
    d["mp_ref_kf"][:n_mp] = rng.randint(0, n_kf, n_mp)
    d["mp_normal"][:n_mp] = [0, 0, 1]
    d["mp_min_dist"][:n_mp], d["mp_max_dist"][:n_mp] = 1.0, 9.0
    d["n_kf"], d["n_mp"] = np.int32(n_kf), np.int32(n_mp)
    return d


def clients(seed=0):
    cj, ct = jcfg.small_synthetic(), tcfg.small_synthetic()
    jc = JClient(cj, 1, JTransport())
    tc = TClient(ct, 1, TTransport(), device="cpu")
    d = client_map(cj, seed)
    jc.slam.m = jms.MapState(**{f: jnp.asarray(v) for f, v in d.items()})
    tc.slam.m = interop.map_from_numpy(d)
    for c, state in ((jc, JState.OK), (tc, TState.OK)):
        c.slam.state = state
        c.slam._ok_streak = 5
        c.slam.ref_kf = 9
        c.slam.T_cur = np.eye(4, dtype=np.float32)
    return jc, tc


def assert_clients_match(jc, tc, atol=1e-6):
    want = {f: np.asarray(getattr(jc.slam.m, f)) for f in jms.MapState._fields}
    got = interop.map_to_numpy(tc.slam.m)
    for f, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[f], w, atol=atol, rtol=atol, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], w, err_msg=f)
    for f in ("_sent_kf", "_sent_mp", "_foreign_kf", "_foreign_mp", "_seq",
              "_gauge_epoch_applied"):
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("_is_foreign_kf", "_is_foreign_mp", "_foreign_mp_rev", "_mp_locked_srv"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f), err_msg=f)
    for f in ("_sent_kf_pose", "_sent_mp_pos", "_gauge_applied"):
        np.testing.assert_allclose(getattr(tc, f), getattr(jc, f), atol=atol, err_msg=f)
    np.testing.assert_allclose(tc.slam.T_cur, jc.slam.T_cur, atol=atol)
    for k, v in jc.stats.items():
        assert tc.stats.get(k) == v, k


def test_build_delta_gives_the_same_uplink_bytes():
    jc, tc = clients()
    # two landmarks and a keyframe arrived as foreign content earlier
    for c in (jc, tc):
        c._is_foreign_mp[[4, 9]] = True
        c._foreign_mp_rev[[4, 9]] = [1000, 1001]
        c._foreign_mp = {1000: 4, 1001: 9}
        c._is_foreign_kf[7] = True
        c._foreign_kf = {55: 7}
    dj, dt = jc._build_delta(), tc._build_delta()
    assert dj.kfs.local_id.tolist() == [0, 1, 2, 3, 4, 5, 6, 8, 9]
    assert (dj.kfs.mp_server >= 0).any()
    assert dj.to_bytes() == dt.to_bytes()
    assert_clients_match(jc, tc)
    # a second build ships only what moved since
    for c in (jc, tc):
        m = c.slam.m
        c.slam.m = m._replace(kf_pose=m.kf_pose.at[2, 0, 3].set(0.7)
                              if isinstance(m.kf_pose, jnp.ndarray)
                              else m.kf_pose.index_put((torch.tensor(2), torch.tensor(0),
                                                        torch.tensor(3)), torch.tensor(0.7)),
                              mp_pos=m.mp_pos.at[3].set(1.0)
                              if isinstance(m.mp_pos, jnp.ndarray)
                              else m.mp_pos.index_put((torch.tensor(3),), torch.tensor(1.0)))
    dj, dt = jc._build_delta(), tc._build_delta()
    # (slot 7, foreign, was never sent, so it counts as moved in both; the
    # server ignores ids it does not know)
    assert dj.kf_updates.local_id.tolist() == [2, 7]
    assert dj.mp_updates.local_id.tolist() == [3]
    assert dj.to_bytes() == dt.to_bytes()


def downlink(seed, n_feat, gauge=True):
    """A server downlink for agent 1: locked corrections of keyframes 2-4
    and landmarks 10-19, a merge gauge, two foreign keyframes with their
    landmarks, refreshes and erasures."""
    rng = np.random.RandomState(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    T[:, :3, 3] = [[0.41, 0.02, 0.01], [0.62, 0.03, 0.0], [0.79, 0.05, -0.01]]
    B, M = 2, 12
    fk = dict(server_id=np.asarray([200, 201], np.int32), owner=np.zeros(B, np.int32),
              timestamp=np.asarray([1.0, 1.5]),
              T_abs=np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)),
              uv=rng.uniform(0, 300, (B, n_feat, 2)).astype(np.float32),
              desc=rng.randint(0, 2 ** 32, (B, n_feat, 8), dtype=np.uint64).astype(np.uint32),
              level=rng.randint(0, 4, (B, n_feat)).astype(np.int32),
              angle=rng.randn(B, n_feat).astype(np.float32),
              feat_valid=rng.rand(B, n_feat) < 0.9,
              mp_server=np.where(rng.rand(B, n_feat) < 0.05,
                                 rng.randint(500, 500 + M, (B, n_feat)), -1).astype(np.int32),
              cam=np.tile(np.asarray([250.0, 250.0, 160.0, 120.0], np.float32), (B, 1)))
    fm = dict(server_id=np.arange(500, 500 + M, dtype=np.int32), owner=np.zeros(M, np.int32),
              pos_abs=(rng.randn(M, 3) + [0, 0, 4]).astype(np.float32),
              desc=rng.randint(0, 2 ** 32, (M, 8), dtype=np.uint64).astype(np.uint32))
    g = np.concatenate([[1.2], np.eye(3).reshape(9), [0.1, -0.2, 0.05]])
    return dict(
        agent=1, ack_seq=1,
        kf_updates=dict(agent=1, local_id=np.asarray([2, 3, 4], np.int32), T_abs=T,
                        locked=np.asarray([True, True, False])),
        mp_updates=dict(agent=1, local_id=np.arange(10, 20, dtype=np.int32),
                        pos_abs=rng.randn(10, 3).astype(np.float32), locked=np.ones(10, bool)),
        foreign_kfs=fk, foreign_mps=fm,
        erased_kf=np.asarray([8], np.int32), erased_mp=np.asarray([40, 41], np.int32),
        gauge_down=g if gauge else None, gauge_epoch=1 if gauge else 0)


def to_delta(proto, d):
    klass = {"kf_updates": proto.KFUpdatePayload, "mp_updates": proto.MPUpdatePayload,
             "foreign_kfs": proto.ForeignKFPayload, "foreign_mps": proto.ForeignMPPayload,
             "foreign_kf_updates": proto.ForeignKFUpdatePayload,
             "foreign_mp_updates": proto.ForeignMPUpdatePayload}
    return proto.MapDelta(**{k: klass[k](**v) if k in klass else v for k, v in d.items()})


@pytest.mark.parametrize("gauge", [True, False])
def test_ingest_corrections_leaves_the_same_map(gauge):
    from multi_orbslam3_tpu_torch.collab import protocol as tproto
    jc, tc = clients(1)
    for c in (jc, tc):
        c._build_delta()                   # everything counts as sent
    n = jcfg.small_synthetic().orb.n_features
    d = downlink(2, n, gauge)
    jc.transport.send_down(1, to_delta(jproto, d).to_bytes())
    tc.transport.send_down(1, to_delta(tproto, d).to_bytes())
    jc._ingest_corrections()
    tc._ingest_corrections()
    assert jc.stats["corrections_applied"] == 2 and jc.stats["foreign_kf"] == 2
    assert_clients_match(jc, tc, atol=1e-5)
    # a second downlink: refreshes and revocations of the foreign content
    d2 = dict(agent=1, ack_seq=2,
              foreign_kf_updates=dict(server_id=np.asarray([201], np.int32),
                                      T_abs=np.eye(4, dtype=np.float32)[None] * 1.0),
              foreign_mp_updates=dict(server_id=np.asarray([501, 502], np.int32),
                                      pos_abs=np.ones((2, 3), np.float32)),
              foreign_erased_kf=np.asarray([200], np.int32),
              foreign_erased_mp=np.asarray([503], np.int32))
    jc.transport.send_down(1, to_delta(jproto, d2).to_bytes())
    tc.transport.send_down(1, to_delta(tproto, d2).to_bytes())
    jc._ingest_corrections()
    tc._ingest_corrections()
    assert jc.stats["foreign_revoked_kf"] == 1
    assert_clients_match(jc, tc, atol=1e-5)
    dbj, dbt = jc.slam.reloc_db, tc.slam.reloc_db
    for f in ("word", "active", "agent"):
        np.testing.assert_array_equal(getattr(dbt, f).numpy(), np.asarray(getattr(dbj, f)))


def test_weak_tracking_defers_the_downlink():
    jc, tc = clients(2)
    for c, st in ((jc, JState.RECENTLY_LOST), (tc, TState.RECENTLY_LOST)):
        c._build_delta()
        c.slam.state = st
    n = jcfg.small_synthetic().orb.n_features
    from multi_orbslam3_tpu_torch.collab import protocol as tproto
    jc.transport.send_down(1, to_delta(jproto, downlink(3, n)).to_bytes())
    tc.transport.send_down(1, to_delta(tproto, downlink(3, n)).to_bytes())
    jc._ingest_corrections()
    tc._ingest_corrections()
    assert len(tc._deferred_down) == len(jc._deferred_down) == 1
    assert_clients_match(jc, tc)


def test_a_post_merge_correction_batch_leaves_the_same_map():
    """The case the free-running trace points to (ROADMAP queue C): after a
    merge (gauge, corrections, foreign content), a later GBA's correction
    batch locks the older keyframes, leaves the newest free, moves landmarks
    and refreshes the foreign copies; the free tail and the live pose are
    carried by _propagate_correction. Both clients must agree."""
    from multi_orbslam3_tpu_torch.collab import protocol as tproto
    jc, tc = clients(3)
    for c in (jc, tc):
        c._build_delta()
    n = jcfg.small_synthetic().orb.n_features
    d = downlink(4, n, True)
    jc.transport.send_down(1, to_delta(jproto, d).to_bytes())
    tc.transport.send_down(1, to_delta(tproto, d).to_bytes())
    jc._ingest_corrections()
    tc._ingest_corrections()
    for c in (jc, tc):
        c._build_delta()
    rng = np.random.RandomState(5)
    ids = np.asarray([0, 1, 2, 3, 5], np.int32)
    T = np.tile(np.eye(4, dtype=np.float32), (len(ids), 1, 1))
    T[:, :3, 3] = np.asarray([[0.2 * k + 0.03, 0.01 * k - 0.02, 0.01] for k in ids])
    T[:, :3, :3] = np.asarray([[[1, 0, 0], [0, np.cos(0.02), -np.sin(0.02)],
                                [0, np.sin(0.02), np.cos(0.02)]]] * len(ids))
    d2 = dict(agent=1, ack_seq=2,
              kf_updates=dict(agent=1, local_id=ids, T_abs=T, locked=np.ones(len(ids), bool)),
              mp_updates=dict(agent=1, local_id=np.arange(30, 45, dtype=np.int32),
                              pos_abs=(rng.randn(15, 3) + [0, 0, 5]).astype(np.float32),
                              locked=np.ones(15, bool)),
              foreign_mp_updates=dict(server_id=np.arange(500, 506, dtype=np.int32),
                                      pos_abs=(rng.randn(6, 3) + [0, 0, 4]).astype(np.float32)))
    jc.transport.send_down(1, to_delta(jproto, d2).to_bytes())
    tc.transport.send_down(1, to_delta(tproto, d2).to_bytes())
    jc._ingest_corrections()
    tc._ingest_corrections()
    assert jc.stats["corrections_applied"] == 2 + len(ids)
    assert_clients_match(jc, tc, atol=1e-5)
    # the free tail moved with its nearest corrected keyframe
    moved = np.abs(np.asarray(jc.slam.m.kf_pose)[6:10] - jc._old_poses[6:10]).max()
    assert moved > 1e-4
