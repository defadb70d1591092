"""Multi-process collaborative client over TCP (counterpart of
apps/run_client.py).

Replaces the reference's orb_slam3_ros_client node + Client<k>_euroc
.launch: runs MonoSlam (or MonoInertialSlam) on a synthetic or EuRoC
sequence and streams map deltas to a run_server process. Writes
KeyFrameTrajectory.txt and prints the client's and its SLAM's stats as
its last line.

Usage:
    python -m multi_orbslam3_tpu_torch.apps.run_client --agent 0 \\
        --server localhost:7007 --out /tmp/client0 [--frames 60] \\
        [--euroc /path/MH_01] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--agent", type=int, required=True)
    ap.add_argument("--server", default="127.0.0.1:7007")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--euroc", default=None)
    ap.add_argument("--inertial", action="store_true",
                    help="mono-inertial agent (the reference's "
                         "IMU_MONOCULAR collaborative mode)")
    ap.add_argument("--small", action="store_true",
                    help="reduced config for smoke runs (must match the "
                         "server's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    from multi_orbslam3_tpu_torch import devices
    device = devices.resolve(args.device, "run_client")
    os.makedirs(args.out, exist_ok=True)
    host, port = args.server.rsplit(":", 1)

    import numpy as np

    from multi_orbslam3_tpu_torch import config as cfg
    from multi_orbslam3_tpu_torch.collab import CollabClient
    from multi_orbslam3_tpu_torch.collab.transport import SocketTransportClient
    from multi_orbslam3_tpu_torch.dataio import synthetic, tum

    if args.euroc:
        c = cfg.euroc_mono_inertial() if args.inertial else cfg.euroc_mono()
    elif args.small:
        c = cfg.small_synthetic()
    else:
        c = cfg.synthetic_mono()
    tr = SocketTransportClient(args.agent, host, int(port))
    client = CollabClient(c, args.agent, tr, inertial=args.inertial, device=device)
    if args.euroc:
        from multi_orbslam3_tpu_torch.dataio import euroc
        for item in euroc.EurocSequence(args.euroc, imu=args.inertial,
                                        max_frames=args.frames):
            if args.inertial:
                t, img, acc, gyro, dt = item
                client.process_frame_imu(img, t, acc, gyro, dt)
            else:
                t, img = item
                client.process_frame(img, t)
            client.comm_cycle()
    else:
        seq = synthetic.make_sequence(c, n_frames=args.frames, n_points=800,
                                      seed=31, phase=0.35 * args.agent,
                                      imu=args.inertial,
                                      lateral=0.8 if args.inertial else 0.4,
                                      sway_freq=0.15 if args.inertial
                                      else 0.08)
        for i in range(args.frames):
            t = float(seq.timestamps[i])
            if args.inertial:
                dt = np.diff(seq.imu_t[i],
                             prepend=seq.imu_t[i][0] - 1 / 200.0)
                dt = np.where(seq.imu_t[i] > 0, np.maximum(dt, 0), 0)
                client.process_frame_imu(seq.images[i], t, seq.imu_acc[i],
                                         seq.imu_gyro[i], dt)
            else:
                client.process_frame(seq.images[i], t)
            client.comm_cycle()
    tum.write_tum(os.path.join(args.out, "KeyFrameTrajectory.txt"),
                  client.slam.keyframe_trajectory())
    print(json.dumps(client.stats | client.slam.stats))
    tr.close()


if __name__ == "__main__":
    main()
