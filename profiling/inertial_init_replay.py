"""Replay dumped inertial initialisations through both packages on the CPU.

    JAX_PLATFORMS=cpu python profiling/inertial_init_replay.py DIR

DIR holds the inertial_init_<n>.npz files of profiling/torch_inertial_tilt.py
--dump (a card run of the port's MonoInertialSlam). For each, the same body
poses and preintegration rows go through the JAX package's
opt/inertial_init.inertial_init and the port's, and again with the body poses
replaced by the true ones (scale 1). Prints one JSON line each: the gravity
both estimate, the angle between them, and each estimate's tilt: the mean
over the keyframes of the angle between the estimated and the true gravity
direction seen from the camera (tests/test_collab_inertial.py's measure, at
the keyframes).
"""

import glob
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tilt(R_wb, T_bc, g_w, T_cw_gt) -> float:
    """Mean angle (deg) between the estimated gravity seen from each camera
    and the true one."""
    R_cw = np.swapaxes(R_wb, -1, -2)                    # R_bw
    R_cw = np.einsum("ij,kjl->kil", T_bc[:3, :3].T, R_cw)
    d = np.einsum("kij,j->ki", R_cw, g_w / np.linalg.norm(g_w))
    t = np.einsum("kij,j->ki", T_cw_gt[:, :3, :3], np.array([0.0, 0.0, -1.0]))
    c = np.clip(np.sum(d * t, 1), -1.0, 1.0)
    return float(np.degrees(np.arccos(c)).mean())


def run_jax(R_wb, p_wb, flat, G, fix_scale, pose_sigma):
    import jax
    import jax.numpy as jnp
    from multi_orbslam3_tpu.imu import preintegration as jpre
    from multi_orbslam3_tpu.opt import inertial_init as jii
    pre = jax.vmap(jpre.flat_to_preint)(jnp.asarray(flat))
    r = jii.inertial_init(jnp.asarray(R_wb), jnp.asarray(p_wb), pre, G=G, fix_scale=fix_scale,
                          pose_sigma=tuple(pose_sigma))
    return np.asarray(r.R_wg, np.float64), float(r.scale)


def run_torch(R_wb, p_wb, flat, G, fix_scale, pose_sigma):
    import torch
    from multi_orbslam3_tpu_torch.imu import preintegration as tpre
    from multi_orbslam3_tpu_torch.opt import inertial_init as tii
    r = tii.inertial_init(torch.from_numpy(R_wb), torch.from_numpy(p_wb),
                          tpre.flat_to_preint(flat), G=G, fix_scale=fix_scale,
                          pose_sigma=tuple(pose_sigma))
    return r.R_wg.numpy().astype(np.float64), float(r.scale)


def main() -> int:
    for path in sorted(glob.glob(os.path.join(sys.argv[1], "inertial_init_*.npz"))):
        d = np.load(path)
        G, T_bc, gt = float(d["G"]), d["T_bc"].astype(np.float64), d["T_cw_gt"]
        args = (float(G), bool(d["fix_scale"]), d["pose_sigma"].tolist())
        T_wb_gt = np.linalg.inv(T_bc[None] @ gt)
        out = {"file": os.path.basename(path), "frames": d["frames"].tolist(),
               "card_scale": float(d["scale"])}
        for name, R, p in (("slam", d["R_wb"], d["p_wb"]),
                           ("true_poses", T_wb_gt[:, :3, :3].astype(np.float32),
                            T_wb_gt[:, :3, 3].astype(np.float32))):
            gj = run_jax(R, p, d["preint_flat"], *args)
            gt_ = run_torch(R, p, d["preint_flat"], *args)
            gw = [Rw @ np.array([0.0, 0.0, -G]) for Rw, _ in (gj, gt_)]
            cosang = np.clip(gw[0] @ gw[1] / (G * G), -1.0, 1.0)
            out[name] = {"jax_scale": gj[1], "port_scale": gt_[1],
                         "jax_port_angle_deg": float(np.degrees(np.arccos(cosang))),
                         "jax_tilt_deg": tilt(R.astype(np.float64), T_bc, gw[0], gt),
                         "port_tilt_deg": tilt(R.astype(np.float64), T_bc, gw[1], gt)}
        card_g = d["R_wg"].astype(np.float64) @ np.array([0.0, 0.0, -G])
        out["card_tilt_deg"] = tilt(d["R_wb"].astype(np.float64), T_bc, card_g, gt)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
