"""Per-frame trace of bench_mono_inertial through either package, and where
two traces part.

    python3 profiling/inertial_trace.py run --package port --device cuda --out FILE
                                            [--seed 7 [8 ...]] [--frames 90] [--dump DIR]
    JAX_PLATFORMS=cpu python profiling/inertial_trace.py run --package port --device cpu --out FILE
    JAX_PLATFORMS=cpu python profiling/inertial_trace.py run --package jax --out FILE
    python profiling/inertial_trace.py compare A B

run: bench_mono_inertial's cell (eval/benchmarks.py: 752x480, EuRoC's T_bc,
1,200 landmarks, a forward trajectory with lateral sway, seed --seed, 90
frames; with several seeds one run each, FILE's "{seed}" replaced by it) through the package's MonoInertialSlam with loop closing on, one
pass on a fresh system as chip_smoke.py's mono_inertial phase drives it
(the bench's warm-up pass is left out); the port runs under torch's
deterministic algorithms. FILE (a pickle) gets, for every frame, what each
inertial stage returned in call order (preintegration of the frame's IMU
window, the visual tracking result the state ladder saw, the VI pose
optimisation, the inertial initialisation, the window BA) and the frame's
end state (live pose, tracking state, keyframes inserted, IMU-initialised
flag, scale, velocity, biases, every valid keyframe pose, a digest of the
landmarks). Prints one JSON line: init frame, scale, frames OK, keyframes
and the keyframe ATE after the init frame as the bench scores it. The port
imports no JAX; --package jax needs JAX on the CPU.

--host-draws (the port only) makes every RANSAC draw on the host: each
device generator gets a CPU twin seeded as it was, whose keys are copied to
the device, so that a run on the card and one on the CPU draw the same
hypotheses (a CUDA generator's stream is not a CPU one's) and can be
compared past the two-view bootstrap.

--dump DIR also writes every call of inertial_init and the first three
calls each of the window BA and the VI pose optimisation, with all their
arguments and the result, as DIR/<stage>_<n>.pkl, for
profiling/inertial_chain_replay.py.

compare: the first frame where two traces part (camera centres more than
1e-4 m apart, or another tracking state, keyframe decision or IMU-init
flag), the first stage of that frame whose outputs differ beyond float32
noise (relative difference above 1e-5 of the larger magnitude, the same
stages in the same order), and the first frame with any stage beyond that
noise. Prints JSON lines.
"""

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NOISE = 1e-5          # relative difference that float32 noise stays below
PART_M = 1e-4         # camera centres further apart than this: the runs part
EUROC_T_BC = (
    0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
    0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
    -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
    0.0, 0.0, 0.0, 1.0)
STAGES = (("pipeline.initializer", "initialize_two_view", "two_view_init"),
          ("imu.preintegration", "preintegrate", "preintegrate"),
          ("opt.vi_pose_opt", "pose_inertial_optimization", "vi_pose_opt"),
          ("opt.inertial_init", "inertial_init", "inertial_init"),
          ("opt.inertial_ba", "inertial_bundle_adjust", "inertial_ba"))
DUMP_CALLS = {"inertial_init": 1000, "inertial_ba": 3, "vi_pose_opt": 3}


def to_np(x):
    """Tensors and arrays of either package to numpy, NamedTuples to
    ("nt", type name, {field: value}), containers element by element."""
    if x is None or isinstance(x, (bool, int, float, str, np.ndarray, np.generic)):
        return x
    if hasattr(x, "_fields"):
        return ("nt", type(x).__name__, {f: to_np(getattr(x, f)) for f in x._fields})
    if isinstance(x, (list, tuple)):
        return type(x)(to_np(v) for v in x)
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fields(rec) -> dict:
    """The arrays of a converted NamedTuple (or a dict of them)."""
    return rec[2] if isinstance(rec, tuple) and rec and isinstance(rec[0], str) \
        and rec[0] == "nt" else rec


class Tracer:
    """Wraps the stage functions of one package's modules and the system's
    state ladder; records per frame."""

    def __init__(self, pkg: str, dump_dir=None):
        import importlib
        self.frames = []
        self.cur = None
        self.dump_dir = dump_dir
        self.dumped = {k: 0 for k in DUMP_CALLS}
        self.restore = []
        for mod_name, fn_name, stage in STAGES:
            mod = importlib.import_module(f"{pkg}.{mod_name}")
            fn = getattr(mod, fn_name)
            setattr(mod, fn_name, self._wrap(fn, stage))
            self.restore.append((mod, fn_name, fn))

    def _wrap(self, fn, stage):
        def traced(*args, **kw):
            out = fn(*args, **kw)
            rec = fields(to_np(out))
            if self.cur is not None:
                self.cur["stages"].append((stage, rec))
                if self.dump_dir and stage in DUMP_CALLS and \
                        self.dumped[stage] < DUMP_CALLS[stage] and \
                        (stage == "inertial_init" or self.dumped["inertial_init"] > 0):
                    path = os.path.join(self.dump_dir, f"{stage}_{self.dumped[stage]}.pkl")
                    with open(path, "wb") as f:
                        pickle.dump({"stage": stage, "frame": self.cur["frame"],
                                     "args": to_np(args), "kwargs": to_np(kw),
                                     "out": rec}, f)
                    self.dumped[stage] += 1
            return out
        return traced

    def close(self):
        for mod, name, fn in self.restore:
            setattr(mod, name, fn)

    def wrap_system(self, slam):
        decide = slam._track_decide

        def traced(feats, res, T_pred, ts, *packed):
            # the port passes the host copy of res.packed; the JAX package
            # reads res.packed (or res.pose and res.n_inliers) itself
            p = packed[0] if packed else getattr(res, "packed", None)
            if p is not None:
                p = np.asarray(to_np(p), np.float64)
                pose, n_in = p[:16].reshape(4, 4), int(p[16])
            else:
                pose, n_in = np.asarray(to_np(res.pose), np.float64), int(to_np(res.n_inliers))
            if self.cur is not None:
                self.cur["stages"].append(("track", {"pose": pose, "n_inliers": n_in}))
            return decide(feats, res, T_pred, ts, *packed)
        slam._track_decide = traced

    def begin(self, i):
        self.cur = {"frame": i, "stages": []}

    def end(self, slam):
        m = slam.m
        n = int(np.asarray(to_np(m.n_kf)))
        kf_valid = np.asarray(to_np(m.kf_valid))[:n]
        mp_valid = np.asarray(to_np(m.mp_valid))
        mp = np.asarray(to_np(m.mp_pos), np.float64)[mp_valid]
        self.cur["end"] = {
            "T_cur": np.asarray(slam.T_cur, np.float64), "state": slam.state.name,
            "kf_inserted": int(slam.stats["kf_inserted"]),
            "imu_initialized": bool(slam.imu_initialized),
            "scale": slam.stats.get("imu_init_scale"),
            "v_cur": np.asarray(slam.v_cur, np.float64),
            "bg": np.asarray(slam.bg, np.float64), "ba": np.asarray(slam.ba_bias, np.float64),
            "kf_pose": np.asarray(to_np(m.kf_pose), np.float64)[:n][kf_valid],
            "mp_count": int(mp.shape[0]),
            "mp_mean": mp.mean(0) if mp.size else np.zeros(3)}
        self.frames.append(self.cur)
        self.cur = None


def host_draws() -> None:
    """Route the port's RANSAC draws (initializer.sample_hypotheses and its
    imports in opt.pnp and opt.sim3_solve) through CPU twins of the
    generators they are given."""
    import torch
    from multi_orbslam3_tpu_torch.opt import pnp, sim3_solve
    from multi_orbslam3_tpu_torch.pipeline import initializer
    twins = {}

    def sample_hypotheses(match_valid, n_hyp, k, generator):
        twin = twins.get(id(generator))
        if twin is None:
            twin = twins[id(generator)] = (torch.Generator(), generator)
            twin[0].manual_seed(generator.initial_seed())
        keys = torch.rand((n_hyp, match_valid.shape[0]), generator=twin[0]).to(
            match_valid.device)
        keys = torch.where(match_valid[None, :], keys, -1.0)
        return torch.topk(keys, k, dim=1).indices
    for mod in (initializer, pnp, sim3_solve):
        mod.sample_hypotheses = sample_hypotheses


def run(args) -> int:
    for seed in args.seed:
        run_one(args, seed)
    return 0


def run_one(args, seed: int) -> None:
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_default_matmul_precision", "highest")
        pkg = "multi_orbslam3_tpu"
        from multi_orbslam3_tpu import config as cfgm
        from multi_orbslam3_tpu.dataio import synthetic
        from multi_orbslam3_tpu.eval import ate
        from multi_orbslam3_tpu.pipeline.inertial_system import MonoInertialSlam
        from multi_orbslam3_tpu.pipeline.system import TrackState
        make = lambda c: MonoInertialSlam(c, enable_loop_closing=True)
        device = "cpu"
    else:
        import torch
        pkg = "multi_orbslam3_tpu_torch"
        from multi_orbslam3_tpu_torch import config as cfgm
        from multi_orbslam3_tpu_torch.dataio import synthetic
        from multi_orbslam3_tpu_torch.eval import ate
        from multi_orbslam3_tpu_torch.pipeline import MonoInertialSlam, TrackState
        torch.use_deterministic_algorithms(True, warn_only=True)
        if args.host_draws:
            host_draws()
        make = lambda c: MonoInertialSlam(c, enable_loop_closing=True, device=args.device)
        device = args.device
    cam = cfgm.CameraConfig(width=752, height=480, fx=458.654, fy=457.296, cx=376.0,
                            cy=240.0)
    c = cfgm.SystemConfig(camera=cam).replace(imu=cfgm.IMUConfig(T_bc=EUROC_T_BC))
    F = args.frames
    seq = synthetic.make_sequence(c, n_frames=F, n_points=1200, seed=seed,
                                  trajectory="forward", imu=True, lateral=0.8,
                                  sway_freq=0.15)
    dump = args.dump.replace("{seed}", str(seed)) if args.dump else None
    if dump:
        os.makedirs(dump, exist_ok=True)
    tracer = Tracer(pkg, dump)
    slam = make(c)
    tracer.wrap_system(slam)
    rate = c.imu.rate_hz
    t0 = time.perf_counter()
    try:
        for i in range(F):
            dt = np.diff(seq.imu_t[i], prepend=seq.imu_t[i][0] - 1.0 / rate)
            dt = np.where(seq.imu_t[i] > 0, np.maximum(dt, 0.0), 0.0)
            tracer.begin(i)
            slam.process_frame_imu(seq.images[i], float(seq.timestamps[i]), seq.imu_acc[i],
                                   seq.imu_gyro[i], dt)
            tracer.end(slam)
    finally:
        tracer.close()
    seconds = time.perf_counter() - t0
    # the bench's score: the final map's keyframes from the init frame on
    init_f = slam.stats.get("imu_init_frame")
    ts0 = float(seq.timestamps[0])
    frames, poses = [], []
    for t, T in slam.keyframe_trajectory():
        fr = int(round((t - ts0) * c.camera.fps))
        if init_f is not None and init_f <= fr < F:
            frames.append(fr)
            poses.append(T)
    summary = {"package": args.package, "device": device, "seed": seed, "frames": F,
               "host_draws": bool(args.package == "port" and args.host_draws),
               "frames_ok": sum(s == TrackState.OK for _, s in slam.frame_log),
               "imu_init_frame": init_f, "imu_init_scale": slam.stats.get("imu_init_scale"),
               "kf_inserted": slam.stats["kf_inserted"], "kf_evaluated": len(frames),
               "seconds": round(seconds, 1)}
    if len(frames) >= 2:
        g = ate.camera_centers(seq.T_cw[frames])
        span = float(np.linalg.norm(g.max(0) - g.min(0)))
        rmse = float(ate.ate_rmse(ate.camera_centers(np.stack(poses)), g))
        summary.update(ate_rmse=rmse, span=span, ate_over_span=rmse / span)
    if device == "cuda":
        import subprocess
        summary["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
    out = args.out.replace("{seed}", str(seed))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump({"summary": summary, "frames": tracer.frames}, f)
    print(json.dumps(summary), flush=True)


def rel_diff(a: dict, b: dict) -> float:
    """The largest relative difference over the float arrays two records
    share (inf where shapes differ, counts differ, or one is finite and
    the other not)."""
    worst = 0.0
    for k in a:
        if k not in b:
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape:
            return float("inf")
        if x.dtype.kind in "biu":
            if not np.array_equal(x, y):
                return float("inf")
            continue
        if x.dtype.kind != "f" or x.size == 0:
            continue
        x, y = x.astype(np.float64), y.astype(np.float64)
        if not np.array_equal(np.isfinite(x), np.isfinite(y)):
            return float("inf")
        fin = np.isfinite(x)
        if not fin.any():
            continue
        scale = max(np.abs(x[fin]).max(), np.abs(y[fin]).max(), 1e-6)
        worst = max(worst, float(np.abs(x[fin] - y[fin]).max() / scale))
    return worst


def centre(T) -> np.ndarray:
    T = np.asarray(T, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def frame_diffs(fa: dict, fb: dict) -> dict:
    sa, sb = fa["stages"], fb["stages"]
    names_a, names_b = [s for s, _ in sa], [s for s, _ in sb]
    stages = [(f"{s}#{k}", rel_diff(ra, rb))
              for k, ((s, ra), (_, rb)) in enumerate(zip(sa, sb))]
    ea, eb = fa["end"], fb["end"]
    decisions = {k: (ea[k], eb[k]) for k in ("state", "kf_inserted", "imu_initialized")
                 if ea[k] != eb[k]}
    if names_a != names_b:
        decisions["stages"] = (names_a, names_b)
    return {"frame": fa["frame"],
            "centre_m": float(np.linalg.norm(centre(ea["T_cur"]) - centre(eb["T_cur"]))),
            "end_rel": rel_diff({k: ea[k] for k in ("T_cur", "v_cur", "bg", "ba")},
                                {k: eb[k] for k in ("T_cur", "v_cur", "bg", "ba")}),
            "decisions": decisions, "stages": stages}


def compare(path_a: str, path_b: str) -> int:
    with open(path_a, "rb") as f:
        A = pickle.load(f)
    with open(path_b, "rb") as f:
        B = pickle.load(f)
    print(json.dumps({"a": A["summary"], "b": B["summary"]}, default=str), flush=True)
    first_noise, first_part, rows = None, None, []
    for fa, fb in zip(A["frames"], B["frames"]):
        d = frame_diffs(fa, fb)
        rows.append(d)
        beyond = [(s, x) for s, x in d["stages"] if x > NOISE]
        if first_noise is None and (beyond or d["end_rel"] > NOISE):
            first_noise = {"frame": d["frame"], "stage": beyond[0][0] if beyond else "end",
                           "rel_diff": beyond[0][1] if beyond else d["end_rel"]}
        if first_part is None and (d["centre_m"] > PART_M or d["decisions"]):
            first_part = d
    out = {"first_frame_beyond_float32_noise": first_noise}
    if first_part is not None:
        i = first_part["frame"]
        beyond = [(s, x) for s, x in first_part["stages"] if x > NOISE]
        out["first_part"] = {
            "frame": i, "centre_m": first_part["centre_m"],
            "decisions": first_part["decisions"],
            "first_stage_beyond_noise": beyond[0] if beyond else None,
            "stages": first_part["stages"]}
    print(json.dumps(out, default=str), flush=True)
    # the centres' distance and the worst stage of every frame, for the record
    print(json.dumps({"per_frame": [
        {"frame": d["frame"], "centre_m": round(d["centre_m"], 7),
         "worst_stage": max(d["stages"], key=lambda s: s[1], default=None),
         "decisions": d["decisions"] or None} for d in rows]}, default=str), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--package", choices=("port", "jax"), default="port")
    r.add_argument("--device", default="cuda")
    r.add_argument("--seed", type=int, nargs="+", default=[7])
    r.add_argument("--frames", type=int, default=90)
    r.add_argument("--out", required=True)
    r.add_argument("--dump", default=None, metavar="DIR")
    r.add_argument("--host-draws", action="store_true")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    return run(args) if args.cmd == "run" else compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
