"""Single-agent SLAM runner for every sensor mode (counterpart of
apps/run_slam.py).

Replaces the reference's per-sensor client nodes + roslaunch
(ros/src/ClientNode.cc, MonoInertialNode.cc, RGBDNode.cc,
RGBDInertialNode.cc): one runner, one ``--sensor`` flag. Feeds a EuRoC
directory (``--euroc``, with on-the-fly stereo rectification for the
stereo modes) or a synthetic ground-truth sequence, writes the TUM
keyframe trajectory (SaveKeyFrameTrajectoryEuRoC semantics), a map
snapshot (map.png) and report.json, and prints one JSON report line with
fps / stats / ATE.

Usage:
    python -m multi_orbslam3_tpu_torch.apps.run_slam --out /tmp/run1 \\
        --sensor imu_stereo [--euroc /path/to/MH_01] [--frames 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

SENSORS = ("mono", "mono_inertial", "stereo", "imu_stereo", "rgbd",
           "imu_rgbd")


def build_system(sensor: str, c, enable_loop_closing: bool, device=None):
    kw = dict(enable_loop_closing=enable_loop_closing, device=device)
    if sensor == "mono":
        from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam
        return MonoSlam(c, **kw)
    if sensor == "mono_inertial":
        from multi_orbslam3_tpu_torch.pipeline.inertial_system import MonoInertialSlam
        return MonoInertialSlam(c, **kw)
    if sensor == "stereo":
        from multi_orbslam3_tpu_torch.pipeline.stereo_system import StereoSlam
        return StereoSlam(c, **kw)
    if sensor == "rgbd":
        from multi_orbslam3_tpu_torch.pipeline.stereo_system import RGBDSlam
        return RGBDSlam(c, **kw)
    if sensor == "imu_stereo":
        from multi_orbslam3_tpu_torch.pipeline.stereo_inertial_system import \
            StereoInertialSlam
        return StereoInertialSlam(c, **kw)
    if sensor == "imu_rgbd":
        from multi_orbslam3_tpu_torch.pipeline.stereo_inertial_system import \
            RGBDInertialSlam
        return RGBDInertialSlam(c, **kw)
    raise ValueError(sensor)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--sensor", choices=SENSORS, default="mono")
    ap.add_argument("--euroc", default=None,
                    help="EuRoC sequence root (with mav0/); synthetic if absent")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--localization", default=None, metavar="MAP_NPZ",
                    help="localization-only mode against a frozen map "
                         "checkpoint (ActivateLocalizationMode analog)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    from multi_orbslam3_tpu_torch import devices
    device = devices.resolve(args.device, "run_slam")
    os.makedirs(args.out, exist_ok=True)

    import numpy as np

    from multi_orbslam3_tpu_torch import config as cfg
    from multi_orbslam3_tpu_torch.dataio import synthetic, tum
    from multi_orbslam3_tpu_torch.eval import ate, viewer
    from multi_orbslam3_tpu_torch.utils.timing import GLOBAL_TIMER

    sensor = args.sensor
    inertial = sensor in ("mono_inertial", "imu_stereo", "imu_rgbd")
    stereoish = sensor in ("stereo", "imu_stereo", "rgbd", "imu_rgbd")
    t_start = time.perf_counter()

    gt = None
    if args.euroc:
        from multi_orbslam3_tpu_torch.dataio import euroc
        if stereoish:
            if sensor in ("rgbd", "imu_rgbd"):
                raise SystemExit("EuRoC has no RGBD stream")
            seq_iter = euroc.EurocStereoSequence(args.euroc, imu=inertial,
                                                 max_frames=args.frames)
            Kn = seq_iter.K_new
            c = cfg.euroc_mono().replace(
                sensor=sensor,
                camera=cfg.CameraConfig(
                    width=seq_iter.width, height=seq_iter.height,
                    fx=float(Kn[0, 0]), fy=float(Kn[1, 1]),
                    cx=float(Kn[0, 2]), cy=float(Kn[1, 2]),
                    baseline=seq_iter.baseline))
            if inertial:
                # rectification rotates the camera frame: T_bc must be
                # body-from-RECTIFIED-left = (T_rect_body)^-1
                T_bc = np.linalg.inv(seq_iter.T_rect_body)
                c = c.replace(imu=cfg.IMUConfig(
                    T_bc=tuple(float(x) for x in T_bc.reshape(-1))))
        else:
            c = cfg.euroc_mono()
            if inertial:
                c = cfg.euroc_mono_inertial()
            seq_iter = euroc.EurocSequence(args.euroc, imu=inertial,
                                           max_frames=args.frames)
    else:
        c = cfg.synthetic_mono()
        if stereoish:
            c = c.replace(
                sensor=sensor,
                camera=cfg.CameraConfig(
                    width=c.camera.width, height=c.camera.height,
                    fx=c.camera.fx, fy=c.camera.fy, cx=c.camera.cx,
                    cy=c.camera.cy, baseline=0.2))
        seq = synthetic.make_sequence(
            c, n_frames=args.frames, n_points=800, seed=1, imu=inertial,
            lateral=0.8 if inertial else 0.4,
            sway_freq=0.15 if inertial else 0.08)
        gt = seq.T_cw

    slam = build_system(sensor, c, enable_loop_closing=not args.no_loop_closing,
                        device=device)
    if args.localization:
        slam.activate_localization_mode(args.localization)

    def imu_batch(i):
        dt = np.diff(seq.imu_t[i], prepend=seq.imu_t[i][0] - 1 / 200.0)
        dt = np.where(seq.imu_t[i] > 0, np.maximum(dt, 0), 0)
        return seq.imu_acc[i], seq.imu_gyro[i], dt

    n = 0
    states = []
    if args.euroc:
        for item in seq_iter:
            with GLOBAL_TIMER.stage("frame"):
                if sensor == "mono":
                    states.append(slam.process_frame(item[1], item[0]))
                elif sensor == "mono_inertial":
                    t, img, acc, gyro, dt = item
                    states.append(slam.process_frame_imu(img, t, acc, gyro,
                                                         dt))
                elif sensor == "stereo":
                    t, left, right = item
                    states.append(slam.process_frame_stereo(left, right, t))
                else:   # imu_stereo
                    t, left, right, acc, gyro, dt = item
                    states.append(slam.process_frame_stereo_imu(
                        left, right, t, acc, gyro, dt))
            n += 1
    else:
        for i in range(seq.images.shape[0]):
            t = float(seq.timestamps[i])
            with GLOBAL_TIMER.stage("frame"):
                if sensor == "mono":
                    states.append(slam.process_frame(seq.images[i], t))
                elif sensor == "mono_inertial":
                    states.append(slam.process_frame_imu(
                        seq.images[i], t, *imu_batch(i)))
                elif sensor == "stereo":
                    states.append(slam.process_frame_stereo(
                        seq.images[i], seq.images_right[i], t))
                elif sensor == "imu_stereo":
                    states.append(slam.process_frame_stereo_imu(
                        seq.images[i], seq.images_right[i], t,
                        *imu_batch(i)))
                elif sensor == "rgbd":
                    states.append(slam.process_frame_rgbd(
                        seq.images[i], seq.depths[i], t))
                else:   # imu_rgbd
                    states.append(slam.process_frame_rgbd_imu(
                        seq.images[i], seq.depths[i], t, *imu_batch(i)))
            n += 1
    wall = time.perf_counter() - t_start

    tum.write_tum(os.path.join(args.out, "KeyFrameTrajectory.txt"),
                  slam.keyframe_trajectory())
    viewer.plot_map(slam.m, os.path.join(args.out, "map.png"),
                    title=f"{sensor} map ({n} frames)",
                    gt_centers=ate.camera_centers(gt) if gt is not None
                    else None)
    report = {"sensor": sensor, "frames": n, "fps": round(n / wall, 2),
              "stats": slam.stats, "timing": GLOBAL_TIMER.summary()}
    if gt is not None:
        from multi_orbslam3_tpu_torch.eval.benchmarks import _ate_over_ok
        skip = slam.stats.get("imu_init_frame", -1) + 2 if inertial else 0
        acc = _ate_over_ok(slam.trajectory, states, gt, skip_head=skip,
                           with_scale=not stereoish)
        if acc:
            report.update(acc)
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
