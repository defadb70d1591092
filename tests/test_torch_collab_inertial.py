"""The inertial half of the port's collaboration against the JAX package,
on the CPU.

Client: both packages' CollabClient(inertial=True) hold the same map and
the same preintegration windows (made by the JAX package from one seeded
IMU stream and carried across as flat rows), so _build_delta must give
the same uplink bytes (the preintegration and velocity rows, T_bc), and
the same downlink (locked corrections, a merge gauge, erasure notices)
must leave the same kf_velocity, v_cur, live pose and windows (floats to
1e-5).

Server: tests/test_full_inertial_gba.py's drifted inertial arena, built by
the JAX package and carried to the port by a server checkpoint, through
_merge_preint_forward, _splice_orphan_preints, _estimate_agent_gravity,
run_inertial_refinement and run_full_inertial_ba: poses, velocities and
landmarks to 1e-3 (tests/test_torch_imu.py's tolerance for the inertial
solvers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu import config as jcfg
from multi_orbslam3_tpu.collab import protocol as jproto
from multi_orbslam3_tpu.collab.client import CollabClient as JClient
from multi_orbslam3_tpu.collab.transport import InProcessTransport as JTransport
from multi_orbslam3_tpu.imu import preintegration as jpre
from multi_orbslam3_tpu.map import mapstate as jms
from multi_orbslam3_tpu.pipeline.system import TrackState as JState
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.collab import protocol as tproto
from multi_orbslam3_tpu_torch.collab.client import CollabClient as TClient
from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport as TTransport
from multi_orbslam3_tpu_torch.imu import preintegration as tpre
from multi_orbslam3_tpu_torch.pipeline.system import TrackState as TState

from test_torch_collab_client import client_map, downlink, to_delta

torch.set_num_threads(2)
N_KF = 10


def window(rng, cfg):
    """One JAX preintegration window of 10 random IMU samples at 200 Hz."""
    S = 10
    acc = rng.randn(S, 3).astype(np.float32) + [0, 0, 9.81]
    gyro = (rng.randn(S, 3) * 0.2).astype(np.float32)
    dt = np.full(S, 1.0 / 200.0, np.float32)
    return jpre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dt),
                             jnp.zeros(3), jnp.zeros(3), jpre.ImuCalib.from_config(cfg.imu))


def inertial_clients(seed=0, ready=True):
    """An inertial client of each package on one map, with windows on
    keyframes 1-9 (none on 4), velocities, a running accumulator and the
    live state."""
    cj, ct = jcfg.small_synthetic(), tcfg.small_synthetic()
    jc = JClient(cj, 1, JTransport(), inertial=True)
    tc = TClient(ct, 1, TTransport(), inertial=True, device="cpu")
    d = client_map(cj, seed, n_kf=N_KF)
    jc.slam.m = jms.MapState(**{f: jnp.asarray(v) for f, v in d.items()})
    tc.slam.m = interop.map_from_numpy(d)
    rng = np.random.RandomState(seed + 100)
    vel = rng.randn(cj.map.max_keyframes, 3).astype(np.float32)
    T_last = np.eye(4, dtype=np.float32)
    T_last[:3, 3] = [1.7, 0.05, 0.0]
    T_cur = T_last.copy()
    T_cur[:3, 3] += [0.03, 0.0, 0.01]
    wins = {k: window(rng, cj) for k in range(1, N_KF) if k != 4}
    acc = window(rng, cj)
    for c, state in ((jc, JState.OK), (tc, TState.OK)):
        s = c.slam
        s.state, s._ok_streak, s.ref_kf = state, 5, N_KF - 1
        s.T_cur, s._last_ok_T = T_cur.copy(), T_last.copy()
        s.v_cur = np.asarray([0.5, -0.1, 0.02], np.float32)
        s.kf_velocity[:] = vel
        s.inertial_ready = s.imu_initialized = ready
        s._prev_state = (T_last.copy(), s.v_cur.copy(), np.zeros(3, np.float32),
                         np.zeros(3, np.float32))
    for k, w in wins.items():
        jc.slam.kf_preint[k] = w
        tc.slam._set_kf_window(k, window_t(w))
    jc.slam._accum = acc
    tc.slam._accum = window_t(acc)
    return jc, tc


def window_t(w):
    """The JAX window carried to the port (its flat row)."""
    from multi_orbslam3_tpu_torch.pipeline.inertial_system import _Window
    p = tpre.flat_to_preint(jpre.preint_to_flat(w))
    return _Window(p, float(w.dT))


def flat(p):
    return None if p is None else np.asarray(jpre.preint_to_flat(p) if isinstance(
        p.dR, jnp.ndarray) else tpre.preint_to_flat(p))


def assert_inertial_match(jc, tc, atol=1e-5):
    js, ts = jc.slam, tc.slam
    np.testing.assert_allclose(ts.kf_velocity, js.kf_velocity, atol=atol)
    np.testing.assert_allclose(ts.v_cur, js.v_cur, atol=atol)
    np.testing.assert_allclose(ts.T_cur, js.T_cur, atol=atol)
    np.testing.assert_allclose(ts._last_ok_T, js._last_ok_T, atol=atol)
    assert (ts._prev_state is None) == (js._prev_state is None)
    assert bool(ts._v_fresh) == bool(getattr(js, "_v_fresh", False))
    for k in range(js.cfg.map.max_keyframes):
        fj, ft = flat(js.kf_preint[k]), flat(ts.kf_preint[k])
        assert (fj is None) == (ft is None), k
        if fj is not None:
            np.testing.assert_allclose(ft, fj, rtol=1e-5, atol=atol, err_msg=str(k))
            assert ts.kf_preint_dt[k] == pytest.approx(float(fj[jpre.FLAT_DT]), abs=1e-6)
    np.testing.assert_allclose(flat(ts._accum.p), flat(js._accum), rtol=1e-5, atol=atol)
    assert ts._accum.dt == pytest.approx(float(js._accum.dT), abs=1e-6)
    want = np.asarray(js.m.kf_pose)
    np.testing.assert_allclose(ts.m.kf_pose.numpy(), want, atol=atol)
    np.testing.assert_allclose(ts.m.mp_pos.numpy(), np.asarray(js.m.mp_pos), atol=atol)


def test_build_delta_of_an_inertial_agent_gives_the_same_uplink_bytes():
    jc, tc = inertial_clients()
    dj, dt = jc._build_delta(), tc._build_delta()
    assert dj.inertial and dj.T_bc is not None and dj.kfs.imu is not None
    assert (dj.kfs.imu[1:, jpre.FLAT_DT] > 0).sum() == N_KF - 2     # none on 0 and 4
    assert dj.to_bytes() == dt.to_bytes()
    back = tproto.MapDelta.from_bytes(dt.to_bytes())
    np.testing.assert_array_equal(back.kfs.imu, dj.kfs.imu)
    np.testing.assert_array_equal(back.T_bc, np.asarray(tc.slam.T_bc, np.float32))


def test_nothing_goes_up_before_the_inertial_initialisation():
    jc, tc = inertial_clients(ready=False)
    assert jc._build_delta() is None and tc._build_delta() is None
    for c in (jc, tc):
        c.slam.inertial_ready = True
    assert jc._build_delta().to_bytes() == tc._build_delta().to_bytes()


@pytest.mark.parametrize("gauge", [True, False])
def test_corrections_carry_the_velocities(gauge):
    """A merge gauge and locked corrections move kf_velocity, v_cur and
    _last_ok_T as the JAX client does, and block the velocity re-anchor;
    erased keyframe 8 hands its window to keyframe 9."""
    jc, tc = inertial_clients(1)
    for c in (jc, tc):
        c._build_delta()
    n = jcfg.small_synthetic().orb.n_features
    d = downlink(2, n, gauge)
    jc.transport.send_down(1, to_delta(jproto, d).to_bytes())
    tc.transport.send_down(1, to_delta(tproto, d).to_bytes())
    jc._ingest_corrections()
    tc._ingest_corrections()
    assert jc.stats["corrections_applied"] == 2
    assert jc.slam.kf_preint[8] is None and jc.slam._v_fresh
    assert tc.slam.kf_preint_dt[9] == pytest.approx(2 * 10 / 200.0, abs=1e-6)
    assert_inertial_match(jc, tc)


@pytest.mark.parametrize("erase", [[5], [9], [4, 5], [5, 6]])
def test_merge_preint_over_folds_an_erased_window_forward(erase):
    """A culled keyframe's window goes to the next own keyframe with one
    (4 has none: its window stays lost, as in the JAX client), or into the
    running accumulator when it was the newest (9, with the live reference
    moved to 8)."""
    jc, tc = inertial_clients(2)
    for c in (jc, tc):
        c._build_delta()
        c.slam.ref_kf = 8
    d = dict(agent=1, ack_seq=1, erased_kf=np.asarray(erase, np.int32))
    jc.transport.send_down(1, to_delta(jproto, d).to_bytes())
    tc.transport.send_down(1, to_delta(tproto, d).to_bytes())
    jc._ingest_corrections()
    tc._ingest_corrections()
    for k in erase:
        assert tc.slam.kf_preint[k] is None
    assert_inertial_match(jc, tc)


# ---------------------------------------------------------------------------
# the server's inertial solves on the drifted arena of test_full_inertial_gba
# ---------------------------------------------------------------------------
F_ARENA = 24


def port_config(c):
    return tcfg.synthetic_mono(width=320, height=240).replace(
        orb=tcfg.ORBConfig(n_features=c.orb.n_features, n_levels=c.orb.n_levels),
        map=tcfg.MapConfig(max_keyframes=c.map.max_keyframes,
                           max_mappoints=c.map.max_mappoints, max_obs=c.map.max_obs,
                           max_obs_per_kf=c.map.max_obs_per_kf),
        local_mapping=tcfg.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                              local_ba_points=1024))


def arena_pair(tmp_path, F=F_ARENA, n_pts=500):
    """The JAX drill's drifted arena (TRUE-motion preintegration rows, yaw
    drift in poses and landmarks) and the port's server loaded from its
    checkpoint."""
    from multi_orbslam3_tpu_torch.collab.server import CollabServer
    from test_full_inertial_gba import _build_drifted_arena, _config
    c = _config()
    js, T_gt, _ = _build_drifted_arena(c, F=F, n_pts=n_pts)
    js.agents[0].T_bc = np.eye(4, dtype=np.float32)
    path = str(tmp_path / "arena.npz")
    js.save_checkpoint(path)
    ts = CollabServer(port_config(c), TTransport(), n_agents=1, device="cpu")
    ts.load_checkpoint(path)
    assert ts.agents[0].inertial
    return js, ts, T_gt


def assert_solved_alike(js, ts, F=F_ARENA, tol=1e-3, first_point=0):
    pj, pt = np.asarray(js.m.kf_pose)[:F], ts.m.kf_pose.numpy()[:F]
    assert np.abs(pt - pj).max() < tol
    np.testing.assert_allclose(ts.kf_imu[:F], js.kf_imu[:F], atol=tol, rtol=tol)
    xj, xt = np.asarray(js.m.mp_pos)[first_point:], ts.m.mp_pos.numpy()[first_point:]
    assert np.abs(xt - xj).max() < tol * max(1.0, np.abs(xj).max())


def test_merge_preint_forward_and_orphan_splice_match_jax(tmp_path):
    js, ts, _ = arena_pair(tmp_path)
    for s in (js, ts):
        s._merge_preint_forward(5, 0)
    np.testing.assert_allclose(ts.kf_imu, js.kf_imu, rtol=1e-5, atol=1e-6)
    assert ts.kf_imu[5, jpre.FLAT_DT] == 0.0
    # the newest keyframe has no successor yet: its window waits as an
    # orphan and is spliced in front of the next row-bearing keyframe
    last = F_ARENA - 1
    row = js.kf_imu[last].copy()
    for s in (js, ts):
        s._merge_preint_forward(last, 0)
        s.kf_imu[last + 1] = row
        s._splice_orphan_preints(0, last + 1)
    assert not ts._orphan_preint[0] and not js._orphan_preint[0]
    np.testing.assert_allclose(ts.kf_imu, js.kf_imu, rtol=1e-5, atol=1e-6)
    assert ts.kf_imu[last + 1, jpre.FLAT_DT] == pytest.approx(2 * row[jpre.FLAT_DT], rel=1e-6)


def test_estimate_agent_gravity_matches_jax(tmp_path):
    js, ts, _ = arena_pair(tmp_path)
    own = np.arange(F_ARENA)
    gj = js._estimate_agent_gravity(own, np.eye(4, dtype=np.float32))
    gt = ts._estimate_agent_gravity(own, np.eye(4, dtype=np.float32))
    assert gj is not None and gt is not None
    np.testing.assert_allclose(gt, gj, atol=1e-3)


def test_run_inertial_refinement_matches_jax(tmp_path):
    js, ts, _ = arena_pair(tmp_path)
    assert js.run_inertial_refinement() == ts.run_inertial_refinement() > 0
    assert_solved_alike(js, ts)


def test_run_full_inertial_ba_matches_jax(tmp_path):
    js, ts, T_gt = arena_pair(tmp_path)
    x0 = ts.m.mp_pos.numpy().copy()
    assert js.run_full_inertial_ba(iters=4) == ts.run_full_inertial_ba(iters=4) == 1
    assert np.abs(ts.m.mp_pos.numpy() - x0).max() > 1e-4        # landmarks moved
    # slot 0 is one of the window's landmarks: the JAX write-back scatters
    # the window's empty rows onto it too (a duplicate index), where XLA's
    # last write, a pad's, keeps its old position; the port's pads go to a
    # spare row and slot 0 takes its solved position
    assert_solved_alike(js, ts, first_point=1)
    np.testing.assert_array_equal(np.asarray(js.m.mp_pos)[0], x0[0])
    assert np.abs(ts.m.mp_pos.numpy()[0] - x0[0]).max() > 1e-3


def test_vi_window_writes_no_pad_row_to_slot_0(tmp_path):
    """The fixed fault of the JAX write-back: the window's landmark rows
    without a landmark (pt_ok False) land in the sacrificial row, so slot
    0 takes exactly the solved position of landmark 0 and no pad's."""
    from multi_orbslam3_tpu_torch.opt import inertial_ba
    _, ts, _ = arena_pair(tmp_path)
    own = np.arange(F_ARENA)
    inp = ts._vi_window_inputs(own, 32, np.eye(4, dtype=np.float32),
                               np.asarray([0, 0, -9.81], np.float32), n_fixed=1, n_pts=2048)
    uniq, pt_ok = inp["uniq"], inp["pt_ok"]
    assert not bool(pt_ok.all()) and 0 in uniq.tolist()
    res = inertial_ba.inertial_bundle_adjust(**inp["solve"], iters=4, fix_points=False)
    calls = []
    real = inertial_ba.inertial_bundle_adjust
    inertial_ba.inertial_bundle_adjust = lambda *a, **k: calls.append(1) or res
    try:
        ts._vi_window(own, 32, np.eye(4, dtype=np.float32),
                      np.asarray([0, 0, -9.81], np.float32), 4, n_fixed=1, n_pts=2048,
                      fix_points=False)
    finally:
        inertial_ba.inertial_bundle_adjust = real
    assert calls
    j0 = int(torch.nonzero(uniq == 0)[0, 0])
    torch.testing.assert_close(ts.m.mp_pos[0], res.points[j0], rtol=0, atol=0)


def test_full_inertial_ba_counts_truncated_landmark_sets(tmp_path):
    """The 4,096-landmark cap of the JAX package, mirrored: a chain that
    observes more distinct landmarks than the cap is counted."""
    _, ts, _ = arena_pair(tmp_path)
    own = np.arange(F_ARENA)
    ts._vi_window(own, 32, np.eye(4, dtype=np.float32), np.asarray([0, 0, -9.81], np.float32),
                  1, n_fixed=1, n_pts=64, fix_points=False)
    assert ts.stats["vi_pts_truncated"] == 1
    ts._vi_window(own, 32, np.eye(4, dtype=np.float32), np.asarray([0, 0, -9.81], np.float32),
                  1, n_fixed=1, n_pts=2048, fix_points=False)
    assert ts.stats["vi_pts_truncated"] == 1


def test_the_ports_drill_arena_equals_the_jax_tests():
    """eval/inertial_drill.build_drifted_arena (chip_smoke.py's
    full_inertial_gba phase) builds test_full_inertial_gba's arena."""
    from multi_orbslam3_tpu_torch.eval import inertial_drill
    from test_full_inertial_gba import _build_drifted_arena, _config
    js, T_gt_j, _ = _build_drifted_arena(_config())
    ts, T_gt_t, _ = inertial_drill.build_drifted_arena(inertial_drill.drill_config(),
                                                       device="cpu")
    np.testing.assert_array_equal(T_gt_t, T_gt_j)
    got = interop.map_to_numpy(ts.m)
    for f in jms.MapState._fields:
        w = np.asarray(getattr(js.m, f))
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[f], w, rtol=1e-6, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], w, err_msg=f)
    np.testing.assert_allclose(ts.kf_imu, js.kf_imu, rtol=1e-6, atol=1e-6)
    for f in ("kf_map", "mp_map", "kf_local"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    assert inertial_drill.arena_ate(ts, T_gt_t) > 0.10


def test_full_inertial_gba_beats_windowed_on_the_port():
    """tests/test_full_inertial_gba.py's gates on the port alone."""
    from multi_orbslam3_tpu_torch.eval import inertial_drill as drill
    server, T_gt, _ = drill.build_drifted_arena(drill.drill_config(), device="cpu")
    ate0 = drill.arena_ate(server, T_gt)
    snap_m, snap_imu = server.m, server.kf_imu.copy()
    assert server.run_inertial_refinement() > 0
    ate_w = drill.arena_ate(server, T_gt)
    server.m, server.kf_imu = snap_m, snap_imu
    assert server.run_full_inertial_ba(iters=12) == 1
    ate_f = drill.arena_ate(server, T_gt)
    assert ate_f < 0.6 * ate0 and ate_f < 0.8 * ate_w, (ate0, ate_w, ate_f)


def drive_inertial_collab(pkg, F=70):
    """tests/test_collab_inertial.py's drill through one package's modules
    ("jax" or "torch"): (VI client, mono client, server, VI sequence, mono
    sequence, deltas the VI client sent before its init)."""
    if pkg == "jax":
        from multi_orbslam3_tpu import config as cm
        from multi_orbslam3_tpu.collab.client import CollabClient
        from multi_orbslam3_tpu.collab.server import CollabServer
        from multi_orbslam3_tpu.collab.transport import InProcessTransport
        from multi_orbslam3_tpu.dataio import synthetic
        kw = {}
    else:
        from multi_orbslam3_tpu_torch import config as cm
        from multi_orbslam3_tpu_torch.collab import CollabClient, CollabServer
        from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport
        from multi_orbslam3_tpu_torch.dataio import synthetic
        kw = {"device": "cpu"}
    c = cm.synthetic_mono(width=320, height=240).replace(
        orb=cm.ORBConfig(n_features=256, n_levels=4),
        map=cm.MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                         max_obs_per_kf=256),
        local_mapping=cm.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                            local_ba_points=1024, local_ba_iters=8),
        loop=cm.LoopConfig(min_map_kfs=6, event_interval_kfs=2))
    sk = dict(n_frames=F, n_points=600, seed=31, trajectory="forward", lateral=0.8,
              sway_freq=0.15)
    seq_vi = synthetic.make_sequence(c, imu=True, **sk)
    seq_m = synthetic.make_sequence(c, phase=0.3, **sk)
    tr = InProcessTransport()
    cl_vi = CollabClient(c, 0, tr, inertial=True, **kw)
    cl_m = CollabClient(c, 1, tr, **kw)
    server = CollabServer(c, tr, n_agents=2, **kw)
    sent_before = 0
    for i in range(F):
        dt = np.diff(seq_vi.imu_t[i], prepend=seq_vi.imu_t[i][0] - 1 / 200.0)
        dt = np.where(seq_vi.imu_t[i] > 0, np.maximum(dt, 0), 0)
        cl_vi.process_frame_imu(seq_vi.images[i], float(seq_vi.timestamps[i]),
                                seq_vi.imu_acc[i], seq_vi.imu_gyro[i], dt)
        cl_m.process_frame(seq_m.images[i], float(seq_m.timestamps[i]))
        if not cl_vi.slam.inertial_ready:
            sent_before = cl_vi.stats["deltas_sent"]
        cl_vi.comm_cycle()
        cl_m.comm_cycle()
        server.comm_cycle(run_gba_on_events=True)
    return cl_vi, cl_m, server, seq_vi, seq_m, sent_before


def drill_outcome(cl_vi, cl_m, server, seq_vi, seq_m, sent_before):
    """The JAX test's measures: VI ATE after init, mean tilt, tilt rise,
    mono post-merge ATE, span."""
    from multi_orbslam3_tpu_torch.eval import ate
    init_f = cl_vi.slam.stats["imu_init_frame"] + 2
    est = np.stack([T for _, T in cl_vi.slam.trajectory])[init_f:]
    gt = seq_vi.T_cw[init_f:]
    g = ate.camera_centers(gt)
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    rmse = ate.ate_rmse(ate.camera_centers(est), g)
    z = np.array([0.0, 0.0, 1.0])
    tilts = np.degrees(np.arccos(np.clip(
        [(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
         for a, b in ((Te[:3, :3] @ z, Tg[:3, :3] @ z) for Te, Tg in zip(est, gt))],
        -1.0, 1.0)))
    start = max(50, init_f + 4)
    est_m = np.stack([T for _, T in cl_m.slam.trajectory])[start:]
    rmse_m = ate.ate_rmse(ate.camera_centers(est_m), ate.camera_centers(seq_m.T_cw[start:]))
    return {"sent_before": sent_before, "merges": server.stats["merges"],
            "vi_corr": cl_vi.stats["corrections_applied"],
            "mono_corr": cl_m.stats["corrections_applied"], "span": span,
            "vi_ate": float(rmse), "tilt_mean": float(tilts.mean()),
            "tilt_rise": float(tilts[-8:].mean() - tilts[:8].mean()),
            "mono_ate": float(rmse_m), "vi_solves": server.stats.get("vi_solves", 0)}


@pytest.mark.slow
def test_inertial_agent_collaborates_like_the_jax_package():
    """The drill through both packages at the JAX test's size: both pass
    its gates (the port's server also ran a joint inertial solve)."""
    outs = {pkg: drill_outcome(*drive_inertial_collab(pkg)) for pkg in ("jax", "torch")}
    for pkg, o in outs.items():
        lim = 0.12 * max(o["span"], 1.0)
        assert o["sent_before"] == 0 and o["merges"] >= 1, (pkg, o)
        assert o["vi_corr"] > 0 and o["mono_corr"] > 0, (pkg, o)
        assert o["vi_ate"] < lim and o["mono_ate"] < lim, (pkg, o)
        assert o["tilt_mean"] < 3.0 and o["tilt_rise"] < 1.5, (pkg, o)
    assert outs["torch"]["vi_solves"] >= 1
