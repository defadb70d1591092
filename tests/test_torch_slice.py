"""The monocular slice of the PyTorch port against the JAX package, on the
CPU at the small synthetic configuration (320x240, 256 features, 4
levels, 64 keyframes / 2048 landmarks):

(a) the fused extract+track step on a map built by the JAX package from
    ground truth and carried across with interop;
(b) the per-keyframe mapping chain on a carried map;
(c) the port's MonoSlam end to end, with the JAX E2E gates;
(d) JAX against the port end to end on the same sequence (slow).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu import config as cfg
from multi_orbslam3_tpu.dataio import synthetic
from multi_orbslam3_tpu.eval import ate
from multi_orbslam3_tpu.frontend import extractor as jex
from multi_orbslam3_tpu.geometry import camera as jcam
from multi_orbslam3_tpu.map import mapstate as jms
from multi_orbslam3_tpu.pipeline import local_mapping as jlm
from multi_orbslam3_tpu.pipeline import system as jsys
from multi_orbslam3_tpu.pipeline import tracking as jtr
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.geometry import camera as tcam
from multi_orbslam3_tpu_torch.pipeline import local_mapping as tlm
from multi_orbslam3_tpu_torch.pipeline import system as tsys
from multi_orbslam3_tpu_torch.pipeline import tracking as ttr


def t(a):
    return torch.from_numpy(np.array(a))


def jax_map_np(m):
    return {f: np.asarray(getattr(m, f)) for f in jms.MapState._fields}


@pytest.fixture(scope="module")
def setup():
    """A JAX-built map from ground truth: keyframe 0 at frame 0 with its
    true pose; each of its features within 4 px of a projected world
    point becomes a landmark, back-projected at that point's true depth."""
    c = cfg.small_synthetic()
    seq = synthetic.make_sequence(c, n_frames=12, n_points=500, seed=7,
                                  trajectory="forward")
    imgs = np.clip(np.round(seq.images), 0, 255).astype(np.uint8)
    n = c.orb.n_features
    m = jms.empty_map(c.map.max_keyframes, c.map.max_mappoints, n)
    f0 = jex.extract_features(jnp.asarray(imgs[0], jnp.float32), c)
    T0 = seq.T_cw[0].astype(np.float64)
    m, _ = jms.add_keyframe(m, f0, jnp.asarray(seq.T_cw[0]), 0.0,
                            jnp.full((n,), -1, jnp.int32), -1)
    cam = c.camera
    pc = seq.points @ T0[:3, :3].T + T0[:3, 3]
    front = pc[:, 2] > 0.3
    proj = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                     cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], 1)
    uv = np.asarray(f0.uv_und).astype(np.float64)
    d = np.linalg.norm(uv[:, None] - proj[None], axis=-1)
    d[:, ~front] = np.inf
    near = d.argmin(1)
    ok = (d.min(1) < 4.0) & np.asarray(f0.valid)
    z = pc[near, 2]
    p_cam = np.stack([(uv[:, 0] - cam.cx) / cam.fx * z,
                      (uv[:, 1] - cam.cy) / cam.fy * z, z], 1)
    p_w = ((p_cam - T0[:3, 3]) @ T0[:3, :3]).astype(np.float32)
    idx = jnp.arange(n, dtype=jnp.int32)
    m, _ = jms.add_mappoints(m, jnp.asarray(p_w), jnp.asarray(ok), f0.desc,
                             0, 0, idx, 0, idx)
    m = jms.refresh_point_stats(m, jnp.zeros(1, jnp.int32), jnp.ones(1, bool),
                                scale_factor=c.orb.scale_factor,
                                n_levels=c.orb.n_levels)
    assert int(m.n_mp) > 100
    return c, seq, imgs, m


def test_fused_step_chained_matches_jax(setup):
    """(a) Pose within 1e-3, n_inliers within 3%, feat_mp equal on >= 95%
    of the features, from the same map, frame and pose chain. Measured on
    the CPU: 69 inliers in both, pose within 3e-8, feat_mp 100% equal."""
    c, seq, imgs, mj = setup
    T_cur = seq.T_cw[4].astype(np.float32)
    T_vel = (seq.T_cw[4] @ np.linalg.inv(seq.T_cw[3])).astype(np.float32)
    fj, rj, pose_j, vel_j = jtr._fused_step_chained(c)(
        mj, jnp.asarray(imgs[5]), jnp.asarray(T_cur), jnp.asarray(T_vel))
    mt = interop.map_from_numpy(jax_map_np(mj))
    ft, rt, pose_t, vel_t = ttr.fused_step_chained(c, mt, t(imgs[5]), t(T_cur), t(T_vel))
    n_j, n_t = int(rj.n_inliers), int(rt.n_inliers)
    assert n_j > 40
    assert abs(n_t - n_j) <= 0.03 * n_j
    np.testing.assert_allclose(pose_t.numpy(), np.asarray(pose_j), atol=1e-3)
    np.testing.assert_allclose(vel_t.numpy(), np.asarray(vel_j), atol=1e-3)
    assert np.mean(rt.feat_mp.numpy() == np.asarray(rj.feat_mp)) >= 0.95
    np.testing.assert_allclose(rt.packed.numpy()[:18], np.asarray(rj.packed)[:18],
                               atol=1e-3 * max(n_j, 1))
    # the pose is also close to the ground truth
    assert np.abs(pose_t.numpy() - seq.T_cw[5]).max() < 0.05


def test_map_keyframe_matches_jax(setup):
    """(b) A new keyframe at frame 6 (ground-truth pose, the JAX tracker's
    associations), then the whole mapping chain on both: n_created and
    n_fused within 10% (+1 for tiny counts), keyframe poses within 1e-3.
    Measured on the CPU: 11 created in both, poses within 2e-6, landmark
    positions within 7e-4."""
    c, seq, imgs, mj = setup
    Kj = jcam.intrinsics_from_config(c.camera)
    fj, rj, _ = jtr.extract_and_track(mj, jnp.asarray(imgs[6]),
                                      jnp.asarray(seq.T_cw[6]), c)
    mj, k = jms.add_keyframe(mj, fj, jnp.asarray(seq.T_cw[6]),
                             float(seq.timestamps[6]), rj.feat_mp, 0)
    kw = tlm.mapping_kwargs(c)
    mt = interop.map_from_numpy(jax_map_np(mj))
    out_j = jlm.map_keyframe(mj, k, Kj, **kw)
    Kt = tcam.intrinsics_from_config(c.camera)
    out_t = tlm.map_keyframe(mt, int(k), Kt, **kw)
    for name in ("n_created", "n_fused"):
        a, b = int(getattr(out_t, name)), int(getattr(out_j, name))
        assert abs(a - b) <= 0.1 * b + 1, (name, a, b)
    assert int(out_j.n_created) > 5
    np.testing.assert_allclose(out_t.map.kf_pose[:2].numpy(),
                               np.asarray(out_j.map.kf_pose[:2]), atol=1e-3)
    assert abs(int(out_t.map.n_mp) - int(out_j.map.n_mp)) <= 0.1 * int(out_j.map.n_mp)


def _run(slam_cls, c, seq, pipelined, **kw):
    slam = slam_cls(c, **kw)
    step = slam.process_frame_pipelined if pipelined else slam.process_frame
    for i in range(seq.images.shape[0]):
        step(seq.images[i], float(seq.timestamps[i]))
    slam.finish()
    states = [s.name for _, s in slam.frame_log]
    n0 = states.index("OK")
    est = np.stack([T for _, T in slam.trajectory])
    e = ate.camera_centers(est[n0:])
    g = ate.camera_centers(seq.T_cw[n0:])
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    return slam, states, ate.ate_rmse(e, g), span


@pytest.fixture(scope="module")
def e2e_seq():
    c = cfg.small_synthetic()
    return c, synthetic.make_sequence(c, n_frames=40, n_points=500, seed=7,
                                      trajectory="forward")


@pytest.mark.parametrize("pipelined", [False, True])
def test_port_end_to_end(e2e_seq, pipelined):
    """(c) The gates of tests/test_pipeline.py's JAX E2E: final state OK,
    >= 3 keyframes, > 25 frames tracked, ATE < 0.05 x span."""
    c, seq = e2e_seq
    slam, states, rmse, span = _run(tsys.MonoSlam, c, seq, pipelined)
    assert slam.state == tsys.TrackState.OK, states
    assert len(states) == seq.images.shape[0]
    assert slam.stats["kf_inserted"] >= 3
    assert slam.stats["frames_tracked"] > 25
    assert rmse < 0.05 * span, f"ATE {rmse:.3f} vs span {span:.2f}"


def test_loop_closing_is_not_ported_yet():
    with pytest.raises(NotImplementedError):
        tsys.MonoSlam(cfg.small_synthetic(), enable_loop_closing=True)


@pytest.mark.slow
def test_port_matches_jax_end_to_end(e2e_seq):
    """(d) Same sequence through both packages (loop closing off in both):
    frames OK within 3 and ATE within 2x of the JAX package's."""
    c, seq = e2e_seq
    _, st_j, ate_j, _ = _run(jsys.MonoSlam, c, seq, True, enable_loop_closing=False)
    _, st_t, ate_t, _ = _run(tsys.MonoSlam, c, seq, True)
    assert abs(st_t.count("OK") - st_j.count("OK")) <= 3
    assert ate_t <= 2.0 * ate_j + 1e-3
