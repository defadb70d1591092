"""Sharded global-BA measurement on a synthetic server arena (counterpart
of multi_orbslam3_tpu/eval/gba_scaling.py).

``make_server_arena`` fills a CollabServer's arena with a geometrically
consistent multi-agent map in the server's real state layout (keyframe
poses along a path, landmarks in front, kf_uv the true projections plus
0.5 px noise, kf_mp filled), from the same numpy draws as the JAX
package's. ``measure_gba`` times CollabServer.run_global_ba on it and
reports PCG iterations per second.

    python -m multi_orbslam3_tpu_torch.eval.gba_scaling [--shards N] [--device cuda]
                                                        [--across-cards]

runs the sharded solve over N shards of the device (a device may repeat),
or with --across-cards one shard on each visible CUDA device, and, for
reference, the unsharded one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from multi_orbslam3_tpu_torch import config as cfg
from multi_orbslam3_tpu_torch.collab.host import fetch
from multi_orbslam3_tpu_torch.collab.server import CollabServer
from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport
from multi_orbslam3_tpu_torch.geometry import se3


def make_server_arena(n_kf: int = 48, n_mp: int = 3072, n_feat: int = 256,
                      n_agents: int = 2, seed: int = 0, device=None) -> CollabServer:
    """A CollabServer (device=None: the card) whose arena holds n_kf
    keyframes of n_agents agents in turn and n_mp landmarks spread along
    the path, with 3 cm of noise on the landmark positions."""
    rng = np.random.RandomState(seed)
    c = cfg.synthetic_mono().replace(
        orb=cfg.ORBConfig(n_features=n_feat),
        map=cfg.MapConfig(max_keyframes=n_kf, max_mappoints=n_mp, max_obs_per_kf=n_feat))
    server = CollabServer(c, InProcessTransport(), n_agents=n_agents, arena_kf=n_kf,
                          arena_mp=n_mp, device=device)
    fx, fy, cx, cy = (float(f) for f in server.K)
    # landmarks along the path (camera centres march in -x, 0.15 a
    # keyframe), the attitude a bounded wobble
    x_span = 4.0 + 0.15 * n_kf
    pts = np.stack([rng.uniform(-x_span, 4, n_mp), rng.uniform(-2, 2, n_mp),
                    rng.uniform(4, 10, n_mp)], 1).astype(np.float32)
    xi = np.asarray([[0.0, 0.08 * np.sin(k / 7.0), 0.0, 0.15 * k, 0.02 * (k % 3), 0.0]
                     for k in range(n_kf)], np.float32)
    poses = se3.exp(torch.from_numpy(xi)).numpy()
    kf_mp = np.full((n_kf, n_feat), -1, np.int32)
    kf_uv = np.zeros((n_kf, n_feat, 2), np.float32)
    feat_valid = np.zeros((n_kf, n_feat), bool)
    order = np.argsort(pts[:, 0])
    px_sorted = pts[order, 0]
    for k in range(n_kf):
        # candidate landmarks near this camera's x
        xk = -0.15 * k
        lo, hi = np.searchsorted(px_sorted, (xk - 8.0, xk + 8.0))
        cand = order[lo:hi]
        if len(cand) < n_feat:
            cand = order[max(0, lo - n_feat):hi + n_feat]
        vis = rng.choice(cand, min(n_feat, len(cand)), replace=False)
        if len(vis) < n_feat:
            vis = np.concatenate([vis, rng.choice(n_mp, n_feat - len(vis))])
        p_c = pts[vis] @ poses[k][:3, :3].T + poses[k][:3, 3]
        uv = np.stack([fx * p_c[:, 0] / p_c[:, 2] + cx, fy * p_c[:, 1] / p_c[:, 2] + cy], 1)
        ok = (p_c[:, 2] > 0.3) & (uv[:, 0] > 0) & (uv[:, 0] < 640) \
            & (uv[:, 1] > 0) & (uv[:, 1] < 480)
        kf_mp[k, ok] = vis[ok]
        kf_uv[k] = uv + rng.randn(n_feat, 2) * 0.5
        feat_valid[k] = ok
    up = server._up
    server.m = server.m._replace(
        kf_pose=up(poses), kf_valid=up(np.ones(n_kf, bool)),
        kf_agent=up((np.arange(n_kf) % n_agents).astype(np.int32)),
        kf_uv=up(kf_uv), kf_mp=up(kf_mp), kf_feat_valid=up(feat_valid),
        n_kf=up(np.asarray(n_kf, np.int32)),
        mp_pos=up(pts + rng.randn(n_mp, 3).astype(np.float32) * 0.03),
        mp_valid=up(np.ones(n_mp, bool)), n_mp=up(np.asarray(n_mp, np.int32)))
    server.kf_map[:] = 0
    server.kf_local[:] = np.arange(n_kf)
    return server


def measure_gba(server: CollabServer, iters: int = 4, cg_iters: int = 25, reps: int = 3,
                force_shard: bool = True, devices=None) -> dict:
    """Best of `reps` timed run_global_ba calls (after one warm-up) on the
    arena; PCG iterations per second. force_shard runs the sharded path
    even on one shard, so rates at every shard count come from one
    implementation."""
    m0 = server.m
    dev = server.device

    def run():
        server.m = m0
        t0 = time.perf_counter()
        server.run_global_ba(iters=iters, cg_iters=cg_iters, force_shard=force_shard,
                             devices=devices)
        fetch({"p": server.m.kf_pose})
        return time.perf_counter() - t0
    run()
    best = min(run() for _ in range(reps))
    total_pcg = iters * cg_iters
    return {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "shards": len(devices) if devices is not None else None,
            "force_shard": force_shard, "gba_iters_per_s": total_pcg / best,
            "wall_s": best, "pcg_iters": total_pcg}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--across-cards", action="store_true",
                    help="one shard on each visible CUDA device instead")
    args = ap.parse_args()
    server = make_server_arena(device=args.device)
    devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())] if args.across_cards
               else [args.device] * args.shards)
    out = measure_gba(server, devices=devices)
    out["unsharded_iters_per_s"] = measure_gba(
        make_server_arena(device=args.device), force_shard=False)["gba_iters_per_s"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
