"""chip_smoke.py's stereo_wide cell through the JAX package, on the CPU.

    python profiling/jax_stereo_wide_cpu.py [--frames 20] [--out FILE]

The cell: StereoSlam with loop closing on, through
process_frame_stereo_pipelined, on the first 20 frames of bench_stereo's
sequence (752x480, baseline 0.11 m, 1,200 landmarks, seed 9, forward,
made as 80 frames like chip_smoke.py's `stereo` phase), with 4,608 ORB
features over 9 levels: more right features than one launch of the port's
stereo match takes (4,096) and, for the pair, more levels than one K1
launch takes (16). Every other value is the bench configuration's but the
map: 4,608 observations a keyframe, 32,768 landmarks and 262,144
observations, so that 20 frames do not fill it. Prints one JSON line
(to --out as well, if given): frames OK, keyframes, landmarks created, the
ATE without scale alignment over the OK frames and the span, the seconds
it took. JAX runs on the CPU with the matmul precision "highest", as the
JAX test suite sets it. These are the reference's numbers printed beside
the cell's gate; about a minute on an 8-core host.
"""

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

N_FEATURES, N_LEVELS = 4608, 9
MAX_MAPPOINTS, MAX_OBS = 32768, 262144


def wide_config(cfg):
    """The cell's configuration (chip_smoke.stereo_wide_config's values)."""
    cam = cfg.CameraConfig(width=752, height=480, fx=458.654, fy=457.296, cx=376.0,
                           cy=240.0, baseline=0.11)
    return cfg.SystemConfig(camera=cam).replace(
        sensor="stereo", orb=cfg.ORBConfig(n_features=N_FEATURES, n_levels=N_LEVELS),
        map=cfg.MapConfig(max_mappoints=MAX_MAPPOINTS, max_obs=MAX_OBS,
                          max_obs_per_kf=N_FEATURES))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from multi_orbslam3_tpu import config as cfg
    from multi_orbslam3_tpu.dataio import synthetic
    from multi_orbslam3_tpu.eval import ate
    from multi_orbslam3_tpu.pipeline.stereo_system import StereoSlam
    from multi_orbslam3_tpu.pipeline.system import TrackState
    c = wide_config(cfg)
    seq = synthetic.make_sequence(c, n_frames=80, n_points=1200, seed=9,
                                  trajectory="forward")
    F = args.frames
    t0 = time.perf_counter()
    slam = StereoSlam(c, enable_loop_closing=True)
    for i in range(F):
        slam.process_frame_stereo_pipelined(seq.images[i], seq.images_right[i],
                                            float(seq.timestamps[i]))
    slam.finish()
    seconds = time.perf_counter() - t0
    states = [s for _, s in slam.frame_log]
    ok = [i for i, s in enumerate(states) if s == TrackState.OK]
    est = np.stack([slam.trajectory[i][1] for i in ok])
    g = ate.camera_centers(seq.T_cw[ok])
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    rmse = float(ate.ate_rmse(ate.camera_centers(est), g, False))
    line = json.dumps({"cell": "stereo_wide", "package": "jax", "backend": jax.default_backend(),
                       "n_features": N_FEATURES, "n_levels": N_LEVELS, "frames": F,
                       "frames_ok": len(ok), "state": slam.state.name,
                       "kf_inserted": slam.stats["kf_inserted"],
                       "mp_created": slam.stats["mp_created"],
                       "ate_rmse_no_scale": rmse, "span": span,
                       "ate_over_span": rmse / span, "seconds": round(seconds, 1)})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
