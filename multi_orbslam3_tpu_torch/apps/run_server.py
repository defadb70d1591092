"""Multi-process collaborative server over TCP (counterpart of
apps/run_server.py).

Replaces the reference's orb_slam3_ros_server node + Server_euroc.launch:
listens for client delta streams on a socket, fuses maps, sends locked
corrections back. Pair with multi_orbslam3_tpu_torch.apps.run_client
processes. Writes server_map.npz (a checkpoint both packages load),
server_map.png and agent{a}_server_traj.txt, and prints the server's
stats as its last line.

Usage:
    python -m multi_orbslam3_tpu_torch.apps.run_server --port 7007 --agents 2 \\
        --out /tmp/server [--duration 120] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=7007)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--out", required=True)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--cycle", type=float, default=0.05)
    ap.add_argument("--idle-exit", type=float, default=0.0,
                    help="exit once every client has disconnected for "
                         "this many seconds (0 = run full duration)")
    ap.add_argument("--small", action="store_true",
                    help="reduced config for smoke runs (must match the "
                         "clients')")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    from multi_orbslam3_tpu_torch import devices
    device = devices.resolve(args.device, "run_server")
    os.makedirs(args.out, exist_ok=True)

    import numpy as np

    from multi_orbslam3_tpu_torch import config as cfg
    from multi_orbslam3_tpu_torch.collab import CollabServer
    from multi_orbslam3_tpu_torch.collab.transport import SocketTransportServer
    from multi_orbslam3_tpu_torch.dataio import checkpoint, tum
    from multi_orbslam3_tpu_torch.eval import viewer

    c = cfg.small_synthetic() if args.small else cfg.synthetic_mono()
    tr = SocketTransportServer(port=args.port)
    print(f"server listening on :{tr.port}", flush=True)
    server = CollabServer(c, tr, n_agents=args.agents, device=device)
    t_end = time.time() + args.duration
    saw_client = False
    idle_since = None
    while time.time() < t_end:
        server.comm_cycle()
        if args.idle_exit > 0:
            live = tr.connected_agents()
            if live:
                saw_client = True
                idle_since = None
            elif saw_client:
                idle_since = idle_since or time.time()
                if time.time() - idle_since > args.idle_exit:
                    break
        time.sleep(args.cycle)
    server.drain_gba()
    checkpoint.save_map(os.path.join(args.out, "server_map.npz"), server.m,
                        extra={"kf_map": server.kf_map,
                               "mp_map": server.mp_map})
    viewer.plot_map(server.m, os.path.join(args.out, "server_map.png"),
                    title="server arena")
    # server keyframe trajectory per agent (SaveKeyFrameTrajectoryEuRoC)
    valid = server.m.kf_valid.cpu().numpy()
    ts = server.m.kf_timestamp.cpu().numpy()
    poses = server.m.kf_pose.cpu().numpy()
    agents = server.m.kf_agent.cpu().numpy()
    for a in range(args.agents):
        sel = valid & (agents == a)
        traj = [(float(ts[i]), poses[i]) for i in np.nonzero(sel)[0]]
        tum.write_tum(os.path.join(args.out, f"agent{a}_server_traj.txt"),
                      traj)
    print(json.dumps(server.stats))
    tr.close()


if __name__ == "__main__":
    main()
