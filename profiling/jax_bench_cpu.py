"""The JAX package's own bench configurations, on the CPU.

    python profiling/jax_bench_cpu.py [--configs mono,stereo,mono_inertial,mini_asl]
                                      [--port] [--out FILE]

Runs multi_orbslam3_tpu/eval/benchmarks.py's bench_mono, bench_stereo,
bench_mono_inertial and bench_mini_asl with JAX on the CPU (the matmul
precision "highest", as the JAX test suite sets it) and prints one JSON line
a configuration (to --out as well, if given): frames OK (where the function
reports them) and tracked, keyframes inserted, ATE, span, the inertial init
scale and frame where there is one, the seconds it took and the function's
whole result. With --port the same configurations run through the PyTorch
port's eval/benchmarks.py instead, on the CPU (device="cpu": the kernels'
plain versions), for a comparison on one machine. bench_mono is driven
for one pass, built as benchmarks.py::bench_mono builds it (its first
pass only warms XLA's caches); the other functions are called as they
stand. These are the reference's accuracy numbers on the CPU, beside the
port's: the TPU runs' digits (BENCH_r05.json) came from another backend.
Takes about 2-6 minutes a configuration on an 8-core host.
"""

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

from multi_orbslam3_tpu.eval import benchmarks as B  # noqa: E402

CONFIGS = ("mono", "stereo", "mono_inertial", "mini_asl")


def bench_mono_one_pass(n_frames: int = 120, seed: int = 5) -> dict:
    """benchmarks.py::bench_mono's system and sequence, driven once the way
    _drive_mono drives its timed pass."""
    from multi_orbslam3_tpu.dataio import synthetic
    from multi_orbslam3_tpu.pipeline.system import MonoSlam
    c = B._euroc_scale_config()
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=1500, seed=seed,
                                  trajectory="forward")
    slam = MonoSlam(c, enable_loop_closing=True)
    F = seq.images.shape[0]
    nxt = slam.to_device(seq.images[0])
    for i in range(F):
        cur = nxt
        if i + 1 < F:
            nxt = slam.to_device(seq.images[i + 1])
        slam.process_frame_pipelined(cur, float(seq.timestamps[i]))
    slam.finish()
    out = {"frames": F, "stats": dict(slam.stats)}
    acc = B._ate_over_ok(slam.trajectory, [s for _, s in slam.frame_log], seq.T_cw)
    if acc:
        out.update(acc)
    return out


RUNNERS = {"mono": bench_mono_one_pass, "stereo": B.bench_stereo,
           "mono_inertial": B.bench_mono_inertial, "mini_asl": B.bench_mini_asl}


def port_runners() -> dict:
    """The port's functions of the same names, on the CPU; bench_mono
    driven for one pass like bench_mono_one_pass."""
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.eval import benchmarks as P
    from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam

    def mono(n_frames: int = 120, seed: int = 5) -> dict:
        c = P._euroc_scale_config()
        seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=1500, seed=seed,
                                      trajectory="forward")
        slam = MonoSlam(c, enable_loop_closing=True, device="cpu")
        for i in range(seq.images.shape[0]):
            slam.process_frame_pipelined(seq.images[i], float(seq.timestamps[i]))
        slam.finish()
        out = {"frames": seq.images.shape[0], "stats": dict(slam.stats)}
        acc = P._ate_over_ok(slam.trajectory, [s for _, s in slam.frame_log], seq.T_cw)
        return {**out, **(acc or {})}

    return {"mono": mono,
            "stereo": lambda: P.bench_stereo(device="cpu"),
            "mono_inertial": lambda: P.bench_mono_inertial(device="cpu"),
            "mini_asl": lambda: P.bench_mini_asl(device="cpu")}


def summary(name: str, package: str, res: dict, seconds: float) -> dict:
    stats = res.get("stats", {})
    return {"config": name, "package": package,
            "backend": "cpu" if package == "port" else jax.default_backend(),
            "frames": res.get("frames"), "frames_ok": res.get("frames_ok"),
            "frames_tracked": stats.get("frames_tracked"),
            "kf_inserted": stats.get("kf_inserted"),
            "kf_evaluated": res.get("kf_evaluated"),
            "ate_rmse": res.get("ate_rmse"), "span": res.get("span"),
            "imu_init_frame": stats.get("imu_init_frame"),
            "imu_init_scale": stats.get("imu_init_scale"),
            "seconds": round(seconds, 1), "result": res}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    runners = port_runners() if args.port else RUNNERS
    package = "port" if args.port else "jax"
    for name in args.configs.split(","):
        t0 = time.perf_counter()
        res = runners[name]()
        line = json.dumps(summary(name, package, res, time.perf_counter() - t0),
                          default=float)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
