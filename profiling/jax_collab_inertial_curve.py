"""The JAX package's collaborative inertial drill at full width, on the CPU.

    python profiling/jax_collab_inertial_curve.py [--frames 170] [--first 88] [--out FILE]

tests/test_collab_inertial.py::test_inertial_agent_collaborates (a
mono-inertial CollabClient and a mono one, a CollabServer over
InProcessTransport) at chip_smoke.py's collab_inertial width: synthetic_mono()
(640x480, 1024 features, 8 levels, 512 keyframes and 16384 landmarks an
agent) with the test's event gates, 1200 points, seed 31, the mono agent at
phase 0.3. After every frame from --first on, the test's gates are evaluated
as if the run had ended there (the sequence and the run are causal: frame i
does not depend on the frame count), and one JSON line is printed (to --out
as well, if given): the VI agent's ATE after init, the mean gravity tilt,
its head and tail, the mono agent's post-merge ATE, and whether every gate
passed. The 8 virtual CPU devices and the matmul precision are the JAX test
suite's (tests/conftest.py). Takes about 15 minutes and 3 GiB for 170 frames.
"""

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

from multi_orbslam3_tpu import config as cfg  # noqa: E402
from multi_orbslam3_tpu.collab.client import CollabClient  # noqa: E402
from multi_orbslam3_tpu.collab.server import CollabServer  # noqa: E402
from multi_orbslam3_tpu.collab.transport import InProcessTransport  # noqa: E402
from multi_orbslam3_tpu.dataio import synthetic  # noqa: E402
from multi_orbslam3_tpu.eval import ate  # noqa: E402


def gates(cl_vi, cl_mono, server, seq_vi, seq_mono, F, sent_before_init) -> dict:
    """The test's measures and gates after the first F frames."""
    out = {"merges": server.stats["merges"], "vi_solves": server.stats.get("vi_solves", 0),
           "corrections": [cl_vi.stats["corrections_applied"],
                           cl_mono.stats["corrections_applied"]]}
    init = cl_vi.slam.stats.get("imu_init_frame")
    if init is None or not cl_vi.slam.imu_initialized:
        return {**out, "passed": False}
    init_f = init + 2
    est = np.stack([T for _, T in cl_vi.slam.trajectory])[init_f:]
    gt = seq_vi.T_cw[init_f:F]
    g = ate.camera_centers(gt)
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    rmse = float(ate.ate_rmse(ate.camera_centers(est), g))
    z = np.array([0.0, 0.0, 1.0])
    tilts = []
    for T_e, T_g in zip(est, gt):
        a, b = T_e[:3, :3] @ z, T_g[:3, :3] @ z
        tilts.append(np.degrees(np.arccos(np.clip(
            a @ b / (np.linalg.norm(a) * np.linalg.norm(b)), -1.0, 1.0))))
    tilts = np.asarray(tilts)
    head, tail = float(tilts[:8].mean()), float(tilts[-8:].mean())
    start = max(50, init_f + 4)
    est_m = np.stack([T for _, T in cl_mono.slam.trajectory])[start:]
    rmse_m = float(ate.ate_rmse(ate.camera_centers(est_m),
                                ate.camera_centers(seq_mono.T_cw[start:F])))
    lim = 0.12 * max(span, 1.0)
    passed = (sent_before_init == 0 and bool(server.agents[0].inertial)
              and out["merges"] >= 1 and min(out["corrections"]) > 0
              and out["vi_solves"] >= 1 and rmse < lim and tilts.mean() < 3.0
              and tail - head < 1.5 and rmse_m < lim)
    return {**out, "imu_init_frame": init, "span": span, "vi_ate_rmse": rmse,
            "tilt_mean_deg": float(tilts.mean()), "tilt_head_deg": head,
            "tilt_tail_deg": tail, "tilt_last_deg": float(tilts[-1]),
            "mono_ate_rmse": rmse_m, "passed": bool(passed)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=170)
    ap.add_argument("--first", type=int, default=88)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    c = cfg.synthetic_mono().replace(loop=cfg.LoopConfig(min_map_kfs=6, event_interval_kfs=2))
    kw = dict(n_frames=args.frames, n_points=1200, seed=31, trajectory="forward",
              lateral=0.8, sway_freq=0.15)
    seq_vi = synthetic.make_sequence(c, imu=True, **kw)
    seq_mono = synthetic.make_sequence(c, phase=0.3, **kw)
    tr = InProcessTransport()
    cl_vi = CollabClient(c, 0, tr, inertial=True)
    cl_mono = CollabClient(c, 1, tr)
    server = CollabServer(c, tr, n_agents=2)
    sink = open(args.out, "w") if args.out else None
    sent_before_init = 0
    t0 = time.time()
    for i in range(args.frames):
        dt = np.diff(seq_vi.imu_t[i], prepend=seq_vi.imu_t[i][0] - 1 / 200.0)
        dt = np.where(seq_vi.imu_t[i] > 0, np.maximum(dt, 0), 0)
        cl_vi.process_frame_imu(seq_vi.images[i], float(seq_vi.timestamps[i]),
                                seq_vi.imu_acc[i], seq_vi.imu_gyro[i], dt)
        cl_mono.process_frame(seq_mono.images[i], float(seq_mono.timestamps[i]))
        if not cl_vi.slam.inertial_ready:
            sent_before_init = cl_vi.stats["deltas_sent"]
        cl_vi.comm_cycle()
        cl_mono.comm_cycle()
        server.comm_cycle(run_gba_on_events=True)
        if i + 1 < args.first:
            continue
        row = json.dumps({"frames": i + 1, "wall_s": round(time.time() - t0, 1),
                          **gates(cl_vi, cl_mono, server, seq_vi, seq_mono, i + 1,
                                  sent_before_init)})
        print(row, flush=True)
        if sink:
            sink.write(row + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
