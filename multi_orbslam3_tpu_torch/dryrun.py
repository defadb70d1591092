"""Multi-device dry run of the collaborative step (counterpart of
``dryrun_multichip`` in the JAX package's __graft_entry__.py).

    python -m multi_orbslam3_tpu_torch.dryrun [--shards 4] [--device cuda]

One process drives a list of devices (a device may repeat):

- phase 1, agent-parallel tracking: one agent's pose optimisation on each
  device (tiny shapes: 128 observations an agent), the total chi2 summed
  across them as the server's reductions are;
- phase 2, the server's sharded global BA on its real arena layout: a
  256-keyframe, 8,192-landmark, 4-agent arena (eval/gba_scaling.py), whose
  observation list CollabServer.run_global_ba shards by landmark owner
  over the devices. The mean reprojection chi2 may not rise by more than
  1%, and every pose and landmark must stay finite.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from multi_orbslam3_tpu_torch.collab.host import fetch
from multi_orbslam3_tpu_torch.eval.gba_scaling import make_server_arena
from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import se3
from multi_orbslam3_tpu_torch.opt import global_ba, pose_opt


def arena_chi2(server) -> float:
    """Mean squared reprojection error (px^2) over the arena's valid
    observations, with the server's default camera."""
    m = server.m
    pt = torch.where(m.kf_mp >= 0, m.kf_mp, 0).long()
    p_c = se3.apply(m.kf_pose[:, None], m.mp_pos[pt])
    uv = cam.project(server.K, p_c)
    valid = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_valid[:, None] & (p_c[..., 2] > 1e-3)
    err = torch.sum((uv - m.kf_uv) ** 2, -1)
    n = torch.clamp(torch.sum(valid.to(torch.int32)), min=1)
    return float(torch.sum(torch.where(valid, err, 0.0)) / n)


def dryrun_multichip(devices) -> dict:
    """Both phases over `devices`; raises AssertionError on a failed check
    and returns the numbers it checked."""
    devices = [torch.device(d) for d in devices]
    A, M = len(devices), 128
    rng = np.random.RandomState(0)
    pts = np.stack([rng.uniform(-2, 2, (A, M)), rng.uniform(-1, 1, (A, M)),
                    rng.uniform(3, 8, (A, M))], -1).astype(np.float32)
    xi = (rng.randn(A, 6) * 0.05).astype(np.float32)

    # ---- phase 1: one agent's tracking pose optimisation a device ----
    chi2, poses = [], []
    for a, d in enumerate(devices):
        K = cam.PinholeK(*(torch.tensor(v, device=d) for v in (200.0, 200.0, 80.0, 60.0)))
        p = torch.from_numpy(pts[a]).to(d)
        T_true = se3.exp(torch.from_numpy(xi[a]).to(d))
        uv = cam.project(K, se3.apply(T_true[None], p))
        res = pose_opt.pose_optimization(
            torch.eye(4, device=d), K, p, uv, torch.ones(M, device=d),
            torch.ones(M, dtype=torch.bool, device=d), rounds=2, iters=5)
        poses.append(res.pose)
        chi2.append(res.chi2)
    total = global_ba._reduce(chi2, devices[0])
    err = [float(torch.linalg.norm(se3.log(P.cpu() @ se3.inverse(se3.exp(torch.from_numpy(x))))))
           for P, x in zip(poses, xi)]
    assert np.isfinite(float(total)), float(total)
    assert max(err) < 1e-3, err

    # ---- phase 2: the server's sharded global BA ----
    server = make_server_arena(n_kf=256, n_mp=8192, n_feat=128, n_agents=4, device=devices[0])
    chi_before = arena_chi2(server)
    server.run_global_ba(iters=2, cg_iters=10, distributed=True, devices=devices)
    snap = fetch(dict(p=torch.isfinite(server.m.kf_pose).all(),
                      x=torch.isfinite(server.m.mp_pos).all()))
    assert bool(snap["p"]) and bool(snap["x"])
    chi_after = arena_chi2(server)
    assert chi_after <= chi_before * 1.01, (chi_before, chi_after)
    return {"shards": A, "devices": sorted({str(d) for d in devices}),
            "tracking_chi2_total": float(total), "tracking_pose_err_max": max(err),
            "gba_runs": server.stats["gba_runs"], "chi2_before": chi_before,
            "chi2_after": chi_after}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(dryrun_multichip([args.device] * args.shards)))


if __name__ == "__main__":
    main()
