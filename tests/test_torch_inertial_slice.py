"""The inertial sensor modes of the PyTorch port end to end on the CPU, on
the configurations of tests/test_inertial_pipeline.py and
tests/test_stereo_inertial.py (320x240, 256 features, 4 levels, 64
keyframes) with those files' gates: IMU initialized, ``inertial_ready``,
the init scale in range (1 +- 1e-5 with the scale fixed), ATE < 0.1 x span,
a finite velocity. The JAX package's own runs of these drills are marked
slow in its suite; the port's take 20-35 s each and stay in the default
run.
"""

import numpy as np
import pytest
import torch

from multi_orbslam3_tpu_torch import config as cfg
from multi_orbslam3_tpu_torch.dataio import synthetic
from multi_orbslam3_tpu_torch.eval import ate
from multi_orbslam3_tpu_torch.geometry import se3, so3
from multi_orbslam3_tpu_torch.pipeline import (MonoInertialSlam, RGBDInertialSlam,
                                               StereoInertialSlam, TrackState)

# several test processes share the machine's cores; torch's intra-op pool
# spinning on all of them makes the many small ops here wait on each other
torch.set_num_threads(2)

SMALL = dict(
    orb=cfg.ORBConfig(n_features=256, n_levels=4),
    map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                      max_obs_per_kf=256),
    local_mapping=cfg.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                         local_ba_points=1024, local_ba_iters=8))


def vi_config(T_bc=None):
    c = cfg.synthetic_mono(width=320, height=240).replace(**SMALL)
    if T_bc is not None:
        c = c.replace(imu=cfg.IMUConfig(T_bc=tuple(float(x) for x in T_bc.reshape(-1))))
    return c


def si_config():
    # camera-IMU extrinsics far from the identity: a 25 degree tilt and a lever arm
    T_bc = np.eye(4)
    T_bc[:3, :3] = so3.exp(torch.tensor([0.3, -0.2, 0.25])).numpy()
    T_bc[:3, 3] = [0.05, -0.03, 0.02]
    return vi_config(T_bc).replace(
        sensor="imu_stereo",
        camera=cfg.CameraConfig(width=320, height=240, fx=400.0, fy=400.0,
                                cx=160.0, cy=120.0, baseline=0.2))


def imu_dt(seq, i):
    dt = np.diff(seq.imu_t[i], prepend=seq.imu_t[i][0] - 1.0 / 200)
    return np.where(seq.imu_t[i] > 0, np.maximum(dt, 0.0), 0.0)


def run_mono_inertial(c, n_frames=70):
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=500, seed=7,
                                  trajectory="forward", imu=True, lateral=0.8,
                                  sway_freq=0.15)
    slam = MonoInertialSlam(c, enable_loop_closing=False, device="cpu")
    states = [slam.process_frame_imu(seq.images[i], float(seq.timestamps[i]),
                                     seq.imu_acc[i], seq.imu_gyro[i], imu_dt(seq, i))
              for i in range(n_frames)]
    return seq, slam, states


def check_mono_inertial(seq, slam, states):
    assert slam.stats["frames_tracked"] > 25, slam.stats
    assert slam.state in (TrackState.OK, TrackState.RECENTLY_LOST)
    assert slam.imu_initialized, "IMU never initialized"
    assert slam.inertial_ready
    s = slam.stats.get("imu_init_scale", 0.0)
    assert 0.05 < s < 50.0, f"scale {s}"
    # the frame log keeps pre-gauge poses: the segments before and after
    # the init are each consistent, with a scale jump between them
    n0 = next(i for i, st in enumerate(states) if st == TrackState.OK)
    init_f = slam.stats["imu_init_frame"]
    est = np.stack([T for _, T in slam.trajectory])
    for a, b in ((n0, init_f - 1), (init_f + 2, len(states))):
        e = ate.camera_centers(est[a:b])
        g = ate.camera_centers(seq.T_cw[a:b])
        rmse = ate.ate_rmse(e, g)
        span = np.linalg.norm(g.max(0) - g.min(0))
        assert rmse < 0.1 * span, f"segment [{a}:{b}] ATE {rmse:.3f} vs span {span:.2f}"
    assert np.all(np.isfinite(slam.v_cur)) and np.linalg.norm(slam.v_cur) < 10.0


@pytest.fixture(scope="module")
def mono_inertial_run():
    return run_mono_inertial(vi_config())


def test_mono_inertial_tracks_and_initializes_imu(mono_inertial_run):
    """Measured on the CPU: init at frame 51, scale 9.50, segment ATEs 0.050 m
    over 3.35 m and 0.038 m over 1.93 m."""
    check_mono_inertial(*mono_inertial_run)


def test_mono_inertial_state_after_the_run(mono_inertial_run):
    """After the init the map is metric and gravity-aligned: the keyframe
    chain's span matches the ground truth's within 25%, the host mirrors of
    the window durations equal the device's dT, the bootstrap window spans
    exactly the gap between the two bootstrap keyframes, and loop closing
    would run the 4-DoF graph."""
    seq, slam, states = mono_inertial_run
    n = int(slam.m.n_kf)
    ts = slam.m.kf_timestamp[:n].numpy()
    for k in range(1, n):
        p = slam.kf_preint[k]
        assert p is not None
        assert abs(float(p.dT) - slam.kf_preint_dt[k]) < 1e-4
        assert abs(float(p.dT) - (ts[k] - ts[k - 1])) < 0.011, k
    assert slam._yaw_only()
    init_f = slam.stats["imu_init_frame"]
    e = ate.camera_centers(np.stack([T for _, T in slam.trajectory])[init_f + 2:])
    g = ate.camera_centers(seq.T_cw[init_f + 2:])
    ratio = np.linalg.norm(e[-1] - e[0]) / np.linalg.norm(g[-1] - g[0])
    assert 0.75 < ratio < 1.25, ratio
    # gravity is world -z after the re-gauge: the body's up axis at rest
    # (the sequence flies level) stays near +z
    assert slam.pending_gauge is not None and slam.pending_gauge[0] == \
        pytest.approx(slam.stats["imu_init_scale"])
    assert np.all(np.isfinite(slam.kf_velocity[:n]))


def test_mono_inertial_with_rotated_offset_extrinsics():
    T_bc = se3.make(so3.exp(torch.tensor([0.05, -0.1, 0.6])),
                    torch.tensor([0.08, -0.02, 0.05])).numpy()
    check_mono_inertial(*run_mono_inertial(vi_config(T_bc)))


@pytest.fixture(scope="module")
def si_seq():
    c = si_config()
    return c, synthetic.make_sequence(c, n_frames=50, n_points=500, seed=11,
                                      trajectory="forward", imu=True,
                                      lateral=0.6, sway_freq=0.15)


def check_metric(slam, seq, min_tracked):
    assert slam.stats["frames_tracked"] > min_tracked, slam.stats
    assert slam.state in (TrackState.OK, TrackState.RECENTLY_LOST)
    est = np.stack([T for _, T in slam.trajectory])
    e = ate.camera_centers(est)
    g = ate.camera_centers(seq.T_cw[:est.shape[0]])
    rmse = ate.ate_rmse(e, g, with_scale=False)
    span = np.linalg.norm(g.max(0) - g.min(0))
    assert rmse < 0.1 * max(span, 1.0), f"ATE {rmse:.3f}, span {span:.2f}"
    assert np.all(np.isfinite(slam.v_cur)) and np.linalg.norm(slam.v_cur) < 10.0


def test_stereo_inertial_tracks_and_initializes_with_fixed_scale(si_seq):
    """Measured on the CPU: init at frame 21, scale exactly 1, ATE 0.112 m
    over 4.10 m without scale alignment."""
    c, seq = si_seq
    slam = StereoInertialSlam(c, enable_loop_closing=False, device="cpu")
    assert slam._fix_scale
    for i in range(seq.images.shape[0]):
        slam.process_frame_stereo_imu(
            seq.images[i], seq.images_right[i], float(seq.timestamps[i]),
            seq.imu_acc[i], seq.imu_gyro[i], imu_dt(seq, i))
    assert slam.imu_initialized, "IMU never initialized"
    assert slam.inertial_ready
    # fixed scale: the init must not re-scale the metric stereo map
    assert abs(slam.stats["imu_init_scale"] - 1.0) < 1e-5
    check_metric(slam, seq, 30)
    # the chain starts at the depth-initialized keyframe, which has no window
    assert slam.kf_preint[0] is None and slam.kf_preint_dt[0] == 0.0
    assert bool((slam.m.kf_ur[:int(slam.m.n_kf)] >= 0).any(dim=1).all())


def test_rgbd_inertial_tracks_and_initializes(si_seq):
    c, seq = si_seq
    slam = RGBDInertialSlam(c.replace(sensor="imu_rgbd"), enable_loop_closing=False,
                            device="cpu")
    for i in range(40):
        slam.process_frame_rgbd_imu(
            seq.images[i], seq.depths[i], float(seq.timestamps[i]),
            seq.imu_acc[i], seq.imu_gyro[i], imu_dt(seq, i))
    assert slam.imu_initialized
    assert abs(slam.stats["imu_init_scale"] - 1.0) < 1e-5
    check_metric(slam, seq, 25)


def test_inertial_keyframes_adopt_their_mapping_result_in_the_same_frame(si_seq):
    """Forced adoption: after every frame nothing is pending, whatever
    defer_mapping says, and the VI window BA has run on the mapped map."""
    c, seq = si_seq
    slam = StereoInertialSlam(c, enable_loop_closing=False, device="cpu")
    slam.defer_mapping = True
    for i in range(14):
        slam.process_frame_stereo_imu(
            seq.images[i], seq.images_right[i], float(seq.timestamps[i]),
            seq.imu_acc[i], seq.imu_gyro[i], imu_dt(seq, i))
        assert slam._pending_map is None and slam._vi_ba_pending is None
    assert slam.stats["kf_inserted"] >= 3


def test_method_resolution_order_of_the_composed_systems():
    from multi_orbslam3_tpu_torch.pipeline import MonoSlam, RGBDSlam, StereoSlam
    assert [k.__name__ for k in RGBDInertialSlam.__mro__[:6]] == [
        "RGBDInertialSlam", "StereoInertialSlam", "MonoInertialSlam", "RGBDSlam",
        "StereoSlam", "MonoSlam"]
    slam = RGBDInertialSlam(si_config(), enable_loop_closing=False, device="cpu")
    # both parents' constructors ran, on the device asked for
    assert slam._baseline_fx == pytest.approx(80.0) and slam.calib.T_bc.device.type == "cpu"
    assert slam._fix_scale and slam._init_kf_count == 5
    assert slam._bf() > 0 and slam._frame_ur() is None
