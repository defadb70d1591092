"""The port's CollabServer against the JAX package's, on the CPU. The
same handcrafted uplink deltas (keyframes with the relative-pose chain,
landmarks, pose and landmark updates, erasures, an out-of-order seq, an
inertial agent's gauge handoff) go to both servers; the arenas (integers
exactly, floats to 1e-6), the host books, the full-arena GBA inputs and
the downlink payloads must agree. Checkpoints travel JAX -> port -> JAX."""

import numpy as np
import pytest
import torch

from multi_orbslam3_tpu import config as jcfg
from multi_orbslam3_tpu.collab import protocol as jproto
from multi_orbslam3_tpu.collab import server as jserver
from multi_orbslam3_tpu.collab.transport import InProcessTransport as JTransport
from multi_orbslam3_tpu.geometry import se3 as jse3
from multi_orbslam3_tpu.map import mapstate as jms
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.collab import protocol as tproto
from multi_orbslam3_tpu_torch.collab import server as tserver
from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport as TTransport

torch.set_num_threads(2)
N_FEAT = 256


def configs():
    return jcfg.small_synthetic(), tcfg.small_synthetic()


def servers(n_agents=2, arena_kf=32, arena_mp=512):
    cj, ct = configs()
    js = jserver.CollabServer(cj, JTransport(), n_agents=n_agents, arena_kf=arena_kf,
                              arena_mp=arena_mp)
    ts = tserver.CollabServer(ct, TTransport(), n_agents=n_agents, arena_kf=arena_kf,
                              arena_mp=arena_mp, device="cpu")
    return js, ts


def pose(k, agent):
    return np.asarray(jse3.exp(np.asarray(
        [0.01 * agent, 0.03 * k, 0.0, 0.2 * k + agent, 0.05 * agent, 0.0], np.float32)))


def uplink(agent, seq, rng, kf_ids, mp_ids, n=N_FEAT, **extra):
    """An uplink delta with keyframes kf_ids (relative-pose chain to the
    two previous ids and the parent), landmarks mp_ids referenced to the
    first keyframe of the batch, and associations to those landmarks."""
    B = len(kf_ids)
    ids = np.asarray(kf_ids, np.int32)
    T_abs = np.stack([pose(k, agent) for k in kf_ids]).astype(np.float32)
    ref_ids = np.stack([ids - 1, ids - 2, ids - 1], 1).astype(np.int32)
    ref_ids[ref_ids < 0] = -1
    T_rel = np.zeros((B, 3, 4, 4), np.float32)
    for b, k in enumerate(kf_ids):
        for r in range(3):
            if ref_ids[b, r] >= 0:
                T_rel[b, r] = T_abs[b] @ np.linalg.inv(pose(int(ref_ids[b, r]), agent))
    mp_local = np.full((B, n), -1, np.int32)
    for b in range(B):
        f = rng.choice(n, len(mp_ids), replace=False)
        mp_local[b, f] = mp_ids
    desc = lambda *s: rng.randint(0, 2 ** 32, s, dtype=np.uint64).astype(np.uint32)  # noqa: E731
    kfs = dict(agent=agent, local_id=ids, timestamp=ids * 0.5 + agent,
               ref_ids=ref_ids, T_rel=T_rel, T_abs=T_abs, is_first=ids == 0,
               uv=rng.uniform(0, 320, (B, n, 2)).astype(np.float32), desc=desc(B, n, 8),
               level=rng.randint(0, 4, (B, n)).astype(np.int32),
               angle=rng.randn(B, n).astype(np.float32),
               feat_valid=rng.rand(B, n) < 0.9, mp_local=mp_local)
    M = len(mp_ids)
    mps = dict(agent=agent, local_id=np.asarray(mp_ids, np.int32),
               ref_kf_local=np.full(M, kf_ids[0], np.int32),
               pos_rel=(rng.randn(M, 3) + [0, 0, 4]).astype(np.float32),
               pos_abs=rng.randn(M, 3).astype(np.float32), desc=desc(M, 8))
    return dict(agent=agent, seq=seq, kfs=kfs, mps=mps, closest_kf=kf_ids[-1],
                cam=np.asarray([250.0, 250.0, 160.0, 120.0], np.float32), **extra)


def updates(agent, seq, rng, kf_ids, mp_ids, **extra):
    B, M = len(kf_ids), len(mp_ids)
    T = np.stack([pose(k, agent) for k in kf_ids]).astype(np.float32)
    T[:, :3, 3] += 0.01
    return dict(agent=agent, seq=seq,
                kf_updates=dict(agent=agent, local_id=np.asarray(kf_ids, np.int32), T_abs=T,
                                locked=np.zeros(B, bool)),
                mp_updates=dict(agent=agent, local_id=np.asarray(mp_ids, np.int32),
                                pos_abs=rng.randn(M, 3).astype(np.float32),
                                locked=np.zeros(M, bool)), **extra)


def to_delta(proto, d):
    klass = {"kfs": proto.KFPayload, "mps": proto.MPPayload,
             "kf_updates": proto.KFUpdatePayload, "mp_updates": proto.MPUpdatePayload}
    return proto.MapDelta(**{k: klass[k](**v) if k in klass else v for k, v in d.items()})


def send(js, ts, d):
    js.transport.send_up(d["agent"], to_delta(jproto, d).to_bytes())
    ts.transport.send_up(d["agent"], to_delta(tproto, d).to_bytes())


def cycle(js, ts, **kw):
    js.comm_cycle(**kw)
    ts.comm_cycle(**kw)


def assert_arenas_match(js, ts, atol=1e-6):
    want = {f: np.asarray(getattr(js.m, f)) for f in jms.MapState._fields}
    got = interop.map_to_numpy(ts.m)
    for f, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[f], w, atol=atol, rtol=atol, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], w, err_msg=f)
    for f in ("kf_map", "mp_map", "mp_locked", "kf_local", "kf_imu"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), err_msg=f)
    for f in ("word", "norm", "active", "agent"):
        np.testing.assert_allclose(getattr(ts.db, f).numpy(), np.asarray(getattr(js.db, f)),
                                   rtol=1e-6, err_msg=f"db.{f}")
    for a, bj in js.agents.items():
        bt = ts.agents[a]
        for f in ("kf_l2s", "mp_l2s", "map_id", "last_kf_slot", "closest_kf", "next_seq",
                  "dirty_kfs", "erased_kf_tomb", "erased_mp_tomb", "inertial"):
            assert getattr(bt, f) == getattr(bj, f), (a, f)
    for k, v in js.stats.items():
        if k != "gba_wall_s":
            assert ts.stats.get(k) == v, (k, ts.stats.get(k), v)


def downlinks(js, ts, agent):
    return js.transport.poll_down(agent), ts.transport.poll_down(agent)


def assert_same_downlink(js, ts, exact=True):
    for a in js.agents:
        pj, pt = downlinks(js, ts, a)
        assert len(pj) == len(pt), a
        for bj, bt in zip(pj, pt):
            if exact:
                assert bj == bt
            else:
                dj, dt = jproto.MapDelta.from_bytes(bj), jproto.MapDelta.from_bytes(bt)
                for name in ("kf_updates", "mp_updates", "foreign_kfs", "foreign_mps",
                             "foreign_kf_updates", "foreign_mp_updates"):
                    xj, xt = getattr(dj, name), getattr(dt, name)
                    assert (xj is None) == (xt is None), name
                    if xj is None:
                        continue
                    for f in vars(xj):
                        vj, vt = getattr(xj, f), getattr(xt, f)
                        if isinstance(vj, np.ndarray) and vj.dtype.kind == "f":
                            np.testing.assert_allclose(vt, vj, atol=1e-5, err_msg=f)
                        elif isinstance(vj, np.ndarray):
                            np.testing.assert_array_equal(vt, vj, err_msg=f)
                for f in ("erased_kf", "erased_mp", "foreign_erased_kf",
                          "foreign_erased_mp"):
                    assert str(getattr(dj, f)) == str(getattr(dt, f)), f
                assert (dj.ack_seq, dj.gauge_epoch) == (dt.ack_seq, dt.gauge_epoch)
                if dj.gauge_down is not None:
                    np.testing.assert_allclose(dt.gauge_down, dj.gauge_down, atol=1e-5)


@pytest.fixture(scope="module")
def ingested():
    """Two agents, three uplinks each (the third arrives before the second),
    then pose/landmark updates and erasures."""
    js, ts = servers()
    rng = np.random.RandomState(0)
    for a in (0, 1):
        d1 = uplink(a, 1, rng, [0, 1, 2], list(range(0, 20)))
        d2 = uplink(a, 2, rng, [3, 4], list(range(20, 35)))
        d3 = uplink(a, 3, rng, [5], list(range(35, 40)))
        send(js, ts, d1)
        send(js, ts, d3)           # out of order: buffered until 2 arrives
    cycle(js, ts)
    assert js.agents[0].next_seq == 2 and 3 in js.agents[0].ooo
    assert_arenas_match(js, ts)
    assert_same_downlink(js, ts)
    rng = np.random.RandomState(1)
    for a in (0, 1):
        send(js, ts, uplink(a, 2, np.random.RandomState(10 + a), [3, 4],
                            list(range(20, 35))))
    cycle(js, ts)
    for a in (0, 1):
        send(js, ts, updates(a, 4, rng, [1, 2, 4], [3, 7, 21],
                             erased_kf=np.asarray([3], np.int32),
                             erased_mp=np.asarray([5, 6], np.int32)))
    cycle(js, ts)
    return js, ts


def test_ingest_matches_jax(ingested):
    js, ts = ingested
    assert js.stats["kf_ingested"] == 12 and js.stats["mp_ingested"] == 80
    assert_arenas_match(js, ts)


def test_the_downlink_payloads_are_byte_identical(ingested):
    js, ts = ingested
    # queue corrections: lock every keyframe, as a GBA adoption does
    js._mark_corrected_and_lock()
    ts._mark_corrected_and_lock()
    js._arena_epoch = getattr(js, "_arena_epoch", 0) + 1
    ts._arena_epoch += 1
    js._downlink()
    ts._downlink()
    assert_same_downlink(js, ts)
    assert_arenas_match(js, ts)


def test_gba_inputs_and_gates_match_jax(ingested):
    js, ts = ingested
    obs_j, K_j, fixed_j, _, _ = js._assemble_gba()
    obs_t, K_t, fixed_t, _, _ = ts._assemble_gba()
    np.testing.assert_array_equal(fixed_t, fixed_j)
    for f in ("kf", "pt", "valid"):
        np.testing.assert_array_equal(getattr(obs_t, f).numpy(), np.asarray(getattr(obs_j, f)))
    assert ts._arena_robust_chi2() == pytest.approx(js._arena_robust_chi2(), rel=1e-5)
    nj = jserver._kf_inlier_counts(js.m.kf_pose, js.m.mp_pos, obs_j, K_j, js.m.max_kf)
    nt = tserver._kf_inlier_counts(ts.m.kf_pose, ts.m.mp_pos, obs_t, K_t, ts.m.max_kf)
    for a, b in zip(nt, nj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_merge_culling_and_vicinity_downlink_match_jax():
    """A merge of agent 1's sub-map into agent 0's by a given Sim3 (the
    pose graph runs on both), then the vicinity downlink: foreign
    keyframes and landmarks, the gauge; then a cull sweep."""
    from multi_orbslam3_tpu.geometry import sim3 as jsim3
    from multi_orbslam3_tpu_torch.geometry import sim3 as tsim3
    js, ts = servers()
    rng = np.random.RandomState(2)
    for a in (0, 1):
        d = uplink(a, 1, rng, list(range(6)), list(range(30)))
        if a == 1:
            # agent 1 also observes agent 0's landmarks (arena slots 0-29)
            free = d["kfs"]["mp_local"] < 0
            srv = np.where(free & (rng.rand(*free.shape) < 0.05),
                           rng.randint(0, 30, free.shape), -1).astype(np.int32)
            d["kfs"]["mp_server"] = srv
        send(js, ts, d)
    cycle(js, ts, run_gba_on_events=False)
    R = np.array(jse3.exp(np.asarray([0, 0, 0.1, 0, 0, 0], np.float32)))[:3, :3]
    t = np.asarray([0.3, -0.1, 0.2], np.float32)
    Sj = jsim3.Sim3(R=jnp_(R), t=jnp_(t), s=jnp_(np.float32(1.1)))
    St = tsim3.Sim3(R=torch.from_numpy(R), t=torch.from_numpy(t), s=torch.tensor(1.1))
    slot_cur, slot_cand = js.agents[1].kf_l2s[5], js.agents[0].kf_l2s[2]
    js._merge_maps(slot_cur, slot_cand, Sj)
    ts._merge_maps(slot_cur, slot_cand, St)
    assert_arenas_match(js, ts, atol=2e-5)
    for a in (0, 1):
        np.testing.assert_allclose(ts.agents[a].gauge_total if ts.agents[a].gauge_total
                                   is not None else 0,
                                   js.agents[a].gauge_total if js.agents[a].gauge_total
                                   is not None else 0, atol=1e-6)
    for s in (js, ts):
        s._mark_corrected_and_lock()
        s._arena_epoch = getattr(s, "_arena_epoch", 0) + 1
        s._downlink()
    sent = [jproto.MapDelta.from_bytes(p) for p in js.transport._down[0]]
    assert any(d.foreign_kfs is not None and d.gauge_down is None for d in sent)
    sent = [jproto.MapDelta.from_bytes(p) for p in js.transport._down[1]]
    assert any(d.foreign_mps is not None and d.gauge_down is not None for d in sent)
    assert_same_downlink(js, ts, exact=False)
    for s in (js, ts):
        s._cull()
    assert_arenas_match(js, ts, atol=2e-5)


def jnp_(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def test_gauge_handoff_matches_jax():
    """An inertial agent's scale/R_gw handoff re-gauges its sub-map, and
    its uplinked IMU rows land in kf_imu (the inertial solves that read
    them are the next slice)."""
    js, ts = servers(n_agents=1, arena_kf=16, arena_mp=128)
    rng = np.random.RandomState(3)
    d = uplink(0, 1, rng, [0, 1], list(range(10)), inertial=True)
    d["kfs"]["imu"] = np.zeros((2, 151), np.float32)
    d["kfs"]["imu"][:, 148:] = rng.randn(2, 3)
    send(js, ts, d)
    cycle(js, ts)
    R_gw = np.asarray(jse3.exp(np.asarray([0.1, -0.2, 0.3, 0, 0, 0], np.float32)))[:3, :3]
    send(js, ts, dict(agent=0, seq=2, scale=2.0, R_gw=R_gw.astype(np.float32),
                      inertial=True))
    cycle(js, ts)
    assert js.stats["gauge_applied"] == 1 and js.agents[0].inertial
    assert_arenas_match(js, ts, atol=1e-5)


def test_checkpoints_travel_jax_to_port_to_jax(ingested, tmp_path):
    js, ts0 = ingested
    p1, p2 = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    js.save_checkpoint(p1)
    _, ts = servers()
    ts.load_checkpoint(p1)
    assert_arenas_match(js, ts, atol=0)
    ts.save_checkpoint(p2)
    js2, _ = servers()
    js2.load_checkpoint(p2)
    assert_arenas_match(js2, ts, atol=0)
    with np.load(p1) as a, np.load(p2) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__host__":
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        import json
        ha, hb = (json.loads(bytes(z["__host__"]).decode()) for z in (a, b))
        assert ha == hb


def test_global_ba_entry_points(tmp_path):
    """run_global_ba(distributed=True) shards the solve over the devices
    (JAX: its 8 virtual CPU devices; the port: 8 shards of the CPU), and
    force_shard=True takes the sharded path on the server's one device;
    each leaves the same arena as the JAX server's call."""
    from multi_orbslam3_tpu.eval.gba_scaling import make_server_arena
    for kw_j, kw_t in (({"distributed": True}, {"distributed": True, "devices": ["cpu"] * 8}),
                       ({"force_shard": True}, {"force_shard": True})):
        js = make_server_arena(n_kf=24, n_mp=1024, n_feat=128, n_agents=2, seed=1)
        path = str(tmp_path / "arena.npz")
        js.save_checkpoint(path)
        ct = tcfg.synthetic_mono().replace(
            orb=tcfg.ORBConfig(n_features=128),
            map=tcfg.MapConfig(max_keyframes=24, max_mappoints=1024, max_obs_per_kf=128))
        ts = tserver.CollabServer(ct, TTransport(), n_agents=2, arena_kf=24, arena_mp=1024,
                                  device="cpu")
        ts.load_checkpoint(path)
        js.run_global_ba(iters=2, cg_iters=10, **kw_j)
        ts.run_global_ba(iters=2, cg_iters=10, **kw_t)
        assert js.stats["gba_runs"] == ts.stats["gba_runs"] == 1
        for f in ("kf_pose", "mp_pos"):
            want = np.asarray(getattr(js.m, f), np.float64)
            got = getattr(ts.m, f).numpy().astype(np.float64)
            assert np.abs(got - want).max() < 1e-3 * np.abs(want).max(), f
        np.testing.assert_array_equal(ts.m.kf_pose_locked.numpy(),
                                      np.asarray(js.m.kf_pose_locked))
