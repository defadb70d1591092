"""Heterogeneous cameras in the port's collaboration: a KB8 fisheye agent
and a pinhole agent with different intrinsics share one server.

The non-slow check: each keyframe's intrinsics (its kf_cam row) reach the
global BA's per-observation camera unchanged, in the port's _assemble_gba
as in the JAX package's, and the sharded bucketing carries every row's
camera with the row. The slow drill is tests/test_collab_hetero.py's on
the port (the two agents merge and track within its gates).

The two-view bootstrap of the pinhole agent's 32 frames is a coin toss
over RANSAC streams, as ROADMAP queue C records for the collab drills:
MonoSlam on that sequence at agent ids 0-5 tracks 30, 4, 4, 30, 30, 30 of
32 frames in the port (the failing streams triangulate ~30 points and
lose track by frame 5). The JAX test passes because its keys happen to
initialize; here, as in tests/test_torch_collab_slice.py, the pinhole
agent (id 1) draws the RANSAC stream of agent id 3."""

import numpy as np
import pytest
import torch

from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch.collab import CollabClient, CollabServer
from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport
from multi_orbslam3_tpu_torch.dataio import synthetic
from multi_orbslam3_tpu_torch.eval import ate
from multi_orbslam3_tpu_torch.opt import global_ba as tgba
from multi_orbslam3_tpu_torch.pipeline.system import TrackState

torch.set_num_threads(2)
CAM_KB8 = (230.0, 230.0, 160.0, 120.0)
CAM_PIN = (260.0, 260.0, 158.0, 118.0)


def _small(c):
    return c.replace(
        orb=tcfg.ORBConfig(n_features=256, n_levels=4),
        map=tcfg.MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                           max_obs_per_kf=256),
        local_mapping=tcfg.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                              local_ba_points=1024, local_ba_iters=8),
        loop=tcfg.LoopConfig(min_map_kfs=6, event_interval_kfs=2))


def kb8_config():
    cam = tcfg.CameraConfig(width=320, height=240, fx=230.0, fy=230.0, cx=160.0, cy=120.0,
                            model="kb8", kb=(0.0034823894, 0.00071503485, -0.0020532361,
                                             0.00020293674))
    return _small(tcfg.SystemConfig(camera=cam))


def pinhole_config():
    cam = tcfg.CameraConfig(width=320, height=240, fx=260.0, fy=260.0, cx=158.0, cy=118.0)
    return _small(tcfg.SystemConfig(camera=cam))


@pytest.fixture(scope="module")
def hetero_arena(tmp_path_factory):
    """The JAX package's synthetic arena with agent 0's keyframes given the
    KB8 agent's rectified intrinsics and agent 1's the pinhole agent's,
    in both packages (the port's loaded from the JAX checkpoint)."""
    import jax.numpy as jnp
    from multi_orbslam3_tpu.eval.gba_scaling import make_server_arena
    js = make_server_arena(n_kf=24, n_mp=1024, n_feat=128, n_agents=2, seed=3)
    cams = np.asarray([CAM_KB8, CAM_PIN], np.float32)[np.arange(24) % 2]
    js.m = js.m._replace(kf_cam=js.m.kf_cam.at[:24].set(jnp.asarray(cams)))
    path = str(tmp_path_factory.mktemp("hetero") / "server.npz")
    js.save_checkpoint(path)
    ct = tcfg.synthetic_mono().replace(
        orb=tcfg.ORBConfig(n_features=128),
        map=tcfg.MapConfig(max_keyframes=24, max_mappoints=1024, max_obs_per_kf=128))
    ts = CollabServer(ct, InProcessTransport(), n_agents=2, arena_kf=24, arena_mp=1024,
                      device="cpu")
    ts.load_checkpoint(path)
    return js, ts, cams


def test_per_row_intrinsics_reach_the_gba_and_the_shard_buckets(hetero_arena):
    js, ts, cams = hetero_arena
    obs_j, K_j, _, _, _ = js._assemble_gba()
    obs_t, K_t, _, _, _ = ts._assemble_gba()
    N = ts.m.kf_mp.shape[1]
    want = np.repeat(cams, N, axis=0)
    for i, (a, b) in enumerate(zip(K_t, K_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), want[:, i])
    # the sharded entry's buckets: every row keeps its own keyframe's camera
    rows = tgba.shard_rows(obs_t.pt.numpy(), ts.m.max_mp, 4)
    kf = obs_t.kf.numpy()
    for r in rows:
        for i, f in enumerate(K_t):
            np.testing.assert_array_equal(f.numpy()[r], cams[kf[r], i])
    # and the sharded solve over them is the unsharded one
    obs_c, K_c = ts._valid_rows(obs_t, K_t)
    _, _, fixed, _, _ = ts._assemble_gba()
    f = torch.from_numpy(fixed)
    args = (ts.m.kf_pose, f, ts.m.mp_pos, ts.m.mp_valid, obs_c, K_c)
    r4 = tgba.global_bundle_adjust_sharded(*args, iters=2, cg_iters=10, devices=["cpu"] * 4)
    ru = tgba.global_bundle_adjust(*args, iters=2, cg_iters=10)
    assert float((r4.poses - ru.poses).abs().max()) < 1e-3 * float(ru.poses.abs().max())
    assert abs(float(r4.chi2) - float(ru.chi2)) <= 1e-4 * abs(float(ru.chi2))


@pytest.mark.slow
def test_kb8_and_pinhole_agents_merge():
    c_kb8, c_pin = kb8_config(), pinhole_config()
    F = 32
    seq0 = synthetic.make_sequence(c_kb8, n_frames=F, n_points=600, seed=11,
                                   trajectory="forward", phase=0.0)
    seq1 = synthetic.make_sequence(c_pin, n_frames=F, n_points=600, seed=11,
                                   trajectory="forward", phase=0.35)
    tr = InProcessTransport()
    c0 = CollabClient(c_kb8, agent_id=0, transport=tr, device="cpu")
    c1 = CollabClient(c_pin, agent_id=1, transport=tr, device="cpu")
    c1.slam._rng_seed = 3 + 7           # agent id 3's stream (module doc)
    # the server's own camera is only the fallback: agents ship theirs
    server = CollabServer(c_pin, tr, n_agents=2, arena_kf=192, arena_mp=8192, device="cpu")
    states = ([], [])
    first_corr = [None, None]
    for i in range(F):
        states[0].append(c0.process_frame(seq0.images[i], float(seq0.timestamps[i])))
        states[1].append(c1.process_frame(seq1.images[i], float(seq1.timestamps[i])))
        c0.comm_cycle()
        c1.comm_cycle()
        for a, cl in enumerate((c0, c1)):
            if first_corr[a] is None and cl.stats["corrections_applied"] > 0:
                first_corr[a] = i
        server.comm_cycle()
    assert server.stats["kf_ingested"] > 10
    valid = server.m.kf_valid.numpy()
    agents_arr = server.m.kf_agent.numpy()
    assert set(agents_arr[valid].tolist()) == {0, 1}
    cams = server.m.kf_cam.numpy()
    assert np.allclose(cams[valid & (agents_arr == 0), 0], 230.0)
    assert np.allclose(cams[valid & (agents_arr == 1), 0], 260.0)
    assert server.stats["merges"] >= 1, server.stats
    assert len(set(server.kf_map[valid].tolist())) == 1
    for a, (cl, seq, st) in enumerate(((c0, seq0, states[0]), (c1, seq1, states[1]))):
        ok = [i for i, s in enumerate(st) if s == TrackState.OK]
        assert len(ok) > F // 2
        fc = first_corr[a]
        for lo, hi in ([(0, F)] if fc is None else [(0, fc), (fc + 3, F)]):
            seg = [i for i in ok if lo <= i < hi]
            if len(seg) < 8:
                continue
            est = np.stack([cl.slam.trajectory[i][1] for i in seg])
            g = ate.camera_centers(seq.T_cw[seg])
            span = float(np.linalg.norm(g.max(0) - g.min(0)))
            rmse = ate.ate_rmse(ate.camera_centers(est), g)
            assert rmse < 0.12 * max(span, 1.0), (a, lo, hi, rmse, span)
