"""Replay dumped inertial stage calls through both packages on the CPU.

    JAX_PLATFORMS=cpu python profiling/inertial_chain_replay.py DIR [--out FILE]

DIR holds the <stage>_<n>.pkl files of profiling/inertial_trace.py run
--dump: every inertial_init call of a bench_mono_inertial run and the
first three calls each of the window BA (inertial_ba.inertial_bundle_adjust)
and the VI pose optimisation (vi_pose_opt.pose_inertial_optimization)
from the first initialisation on, each with all its arguments and the
result of the run that dumped it (the port on the card, or either package
on the CPU). Each call's arguments go, unchanged, through the JAX
package's function and through the port's on the CPU (float32,
deterministic), so both start from one shared state. Prints one JSON line
a call: for the pairs JAX / port-on-CPU, port-on-CPU / the dumping run
and JAX / the dumping run, the differences that matter to the estimator:
inertial_init the angle between the gravity directions (deg), the scale
(relative), the biases and the velocities; the VI pose optimisation the
camera centre (m) and the rotation (deg), the velocity, the biases and the
inlier count; the window BA the largest centre and rotation difference
over the window's keyframes, the velocities, the biases and the
landmarks. "agree" says whether every difference of the JAX / port pair is
within float32 noise as set below.
"""

import argparse
import glob
import json
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# float32 noise after an iterative solve from one state: what the two
# packages' orders of summation may leave (the pose solves run 5-20
# Gauss-Newton steps in float32)
NOISE = {"gravity_deg": 1e-2, "scale_rel": 1e-4, "bias": 1e-4, "velocity": 1e-3,
         "centre_m": 1e-4, "rotation_deg": 1e-2, "points_m": 1e-3}


def from_np(x, pkg):
    """A dumped value as the package's own: arrays to jnp / torch (CPU),
    ("nt", name, fields) to that package's NamedTuple of that name."""
    if isinstance(x, tuple) and x and isinstance(x[0], str) and x[0] == "nt":
        cls = pkg["types"][x[1]]
        return cls(**{f: from_np(v, pkg) for f, v in x[2].items() if f in cls._fields})
    if isinstance(x, (list, tuple)):
        return type(x)(from_np(v, pkg) for v in x)
    if isinstance(x, dict):
        return {k: from_np(v, pkg) for k, v in x.items()}
    if isinstance(x, (np.ndarray, np.generic)):
        return pkg["array"](np.asarray(x))
    return x


def jax_package():
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from multi_orbslam3_tpu.geometry import camera
    from multi_orbslam3_tpu.imu import preintegration
    from multi_orbslam3_tpu.opt import inertial_ba, inertial_init, local_ba, vi_pose_opt

    def array(a):
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        return jnp.asarray(a)
    return {"array": array, "to_np": np.asarray,
            "types": {"Preintegrated": preintegration.Preintegrated,
                      "BAObservations": local_ba.BAObservations,
                      "PinholeK": camera.PinholeK},
            "fns": {"inertial_init": inertial_init.inertial_init,
                    "vi_pose_opt": vi_pose_opt.pose_inertial_optimization,
                    "inertial_ba": inertial_ba.inertial_bundle_adjust}}


def port_package():
    import torch
    from multi_orbslam3_tpu_torch.geometry import camera
    from multi_orbslam3_tpu_torch.imu import preintegration
    from multi_orbslam3_tpu_torch.opt import inertial_ba, inertial_init, local_ba, vi_pose_opt
    torch.use_deterministic_algorithms(True, warn_only=True)
    return {"array": lambda a: torch.from_numpy(np.array(a)),     # keeps 0-d arrays 0-d
            "to_np": lambda t: t.detach().cpu().numpy(),
            "types": {"Preintegrated": preintegration.Preintegrated,
                      "BAObservations": local_ba.BAObservations,
                      "PinholeK": camera.PinholeK},
            "fns": {"inertial_init": inertial_init.inertial_init,
                    "vi_pose_opt": vi_pose_opt.pose_inertial_optimization,
                    "inertial_ba": inertial_ba.inertial_bundle_adjust}}


def call(pkg, rec) -> dict:
    out = pkg["fns"][rec["stage"]](*from_np(rec["args"], pkg), **from_np(rec["kwargs"], pkg))
    return {f: np.asarray(pkg["to_np"](getattr(out, f))) for f in out._fields}


def rot_deg(Ra, Rb) -> float:
    """The angle of Ra^T Rb from its skew part and trace (atan2: exact near
    0, where arccos of the trace of a float32 rotation reads ~0.02 deg)."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(np.linalg.norm(w), (np.trace(M) - 1.0) / 2.0)))


def centre(T) -> np.ndarray:
    T = np.asarray(T, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def vmax(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def diffs(stage: str, a: dict, b: dict) -> dict:
    if stage == "inertial_init":
        down = np.array([0.0, 0.0, -1.0])
        ga, gb = np.asarray(a["R_wg"], np.float64) @ down, np.asarray(b["R_wg"], np.float64) @ down
        return {"gravity_deg": float(np.degrees(np.arccos(np.clip(ga @ gb, -1.0, 1.0)))),
                "scale_rel": abs(float(a["scale"]) / float(b["scale"]) - 1.0),
                "bias": max(vmax(a["bg"], b["bg"]), vmax(a["ba"], b["ba"])),
                "velocity": vmax(a["velocities"], b["velocities"]),
                "scale": [float(a["scale"]), float(b["scale"])]}
    if stage == "vi_pose_opt":
        return {"centre_m": float(np.linalg.norm(centre(a["pose"]) - centre(b["pose"]))),
                "rotation_deg": rot_deg(a["pose"][:3, :3], b["pose"][:3, :3]),
                "velocity": vmax(a["velocity"], b["velocity"]),
                "bias": max(vmax(a["bg"], b["bg"]), vmax(a["ba"], b["ba"])),
                "n_inliers": [int(a["n_inliers"]), int(b["n_inliers"])]}
    pa, pb = np.asarray(a["poses"]), np.asarray(b["poses"])
    return {"centre_m": max(float(np.linalg.norm(centre(x) - centre(y))) for x, y in zip(pa, pb)),
            "rotation_deg": max(rot_deg(x[:3, :3], y[:3, :3]) for x, y in zip(pa, pb)),
            "velocity": vmax(a["velocities"], b["velocities"]),
            "bias": max(vmax(a["bg"], b["bg"]), vmax(a["ba"], b["ba"])),
            "points_m": vmax(a["points"], b["points"]),
            "chi2": [float(a["chi2"]), float(b["chi2"])]}


def agree(d: dict) -> bool:
    return all(d[k] <= lim for k, lim in NOISE.items() if k in d)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    jx, pt = jax_package(), port_package()
    recs = []
    for path in glob.glob(os.path.join(args.dir, "*.pkl")):
        with open(path, "rb") as f:
            recs.append((os.path.basename(path), pickle.load(f)))
    order = {"inertial_init": 0, "inertial_ba": 1, "vi_pose_opt": 2}
    recs.sort(key=lambda r: (r[1]["frame"], order[r[1]["stage"]], r[0]))
    lines = []
    for name, rec in recs:
        stage = rec["stage"]
        j, p, run = call(jx, rec), call(pt, rec), rec["out"]
        d = {"file": name, "stage": stage, "frame": rec["frame"],
             "jax_vs_port_cpu": diffs(stage, j, p),
             "port_cpu_vs_dumping_run": diffs(stage, p, run),
             "jax_vs_dumping_run": diffs(stage, j, run)}
        d["agree"] = agree(d["jax_vs_port_cpu"])
        lines.append(d)
        print(json.dumps(d), flush=True)
    summary = {"calls": len(lines), "all_agree": all(d["agree"] for d in lines),
               "noise": NOISE}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for d in lines + [summary]:
                f.write(json.dumps(d) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
