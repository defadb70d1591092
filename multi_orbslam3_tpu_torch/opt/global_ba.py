"""Global bundle adjustment: implicit Schur complement and PCG, on one
device or sharded over a list of devices (counterpart of
multi_orbslam3_tpu/opt/global_ba.py).

The reduced camera system S = Hcc - E C^-1 E^T is never formed: every PCG
iteration applies S to a vector through observation-level gather, compute
and scatter passes (each O(observations)), preconditioned by the inverted
damped camera blocks. Levenberg-Marquardt step control accepts a
Gauss-Newton step only if it does not raise the mean bounded chi2; the
decision stays on the device (torch.where), so a call reads nothing back.

Sharding (``global_bundle_adjust_sharded``): one process drives a list of
devices, as the JAX entry is one controller over its device mesh. The
observation list is bucketed on the host by landmark owner, so every
landmark's rows live in one shard: the landmark-side sums (Hpp, b_p,
E^T x and the landmark step) stay on their shard, and only the (Kc, 6)
camera sums, the chi2 sums and the landmark step cross shards. Those
partials are summed where the JAX code calls psum: with
torch.cuda.comm.reduce_add across distinct CUDA devices, and by a plain
sum where shards share a device (a device may repeat in the list: the CPU
tests run 8 shards on one CPU, as the JAX tests run 8 virtual devices).
Poses and landmarks are replicated to each device a step.

Plain PyTorch: the JAX version has no Pallas kernel, its products and
scatters are XLA ops. The scatters are index_add, which on a GPU adds with
float atomics in the order the threads arrive, so results agree with the
CPU to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.cuda.comm  # reduce_add; not loaded by `import torch` alone

from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import se3
from multi_orbslam3_tpu_torch.opt import robust
from multi_orbslam3_tpu_torch.opt.local_ba import (BAObservations, _chi2,
                                                  _obs_terms, inv3x3)


class GBAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    chi2: torch.Tensor                    # mean bounded chi2 after the solve
    chi2_in: torch.Tensor = float("nan")  # ... and before it (divergence gate)
    lam: torch.Tensor = float("nan")      # final LM damping (carried on)


class _Shard(NamedTuple):
    """One device's share of the observation list."""
    obs: BAObservations
    K: cam.PinholeK
    kf: torch.Tensor        # obs.kf as int64
    pt: torch.Tensor        # obs.pt as int64


def _shard(obs: BAObservations, K: cam.PinholeK) -> _Shard:
    return _Shard(obs, K, obs.kf.long(), obs.pt.long())


def _reduce(parts, home: torch.device) -> torch.Tensor:
    """The sum of one partial a shard, on `home`: partials that share a
    device add there, distinct CUDA devices meet in reduce_add."""
    by_dev = {}
    for p in parts:
        by_dev[p.device] = p if p.device not in by_dev else by_dev[p.device] + p
    vals = list(by_dev.values())
    if len(vals) == 1:
        return vals[0].to(home)
    if all(v.device.type == "cuda" for v in vals):
        idx = [v.device.index for v in vals]
        dest = home.index if home.type == "cuda" and home.index in idx else idx[0]
        return torch.cuda.comm.reduce_add(vals, destination=dest).to(home)
    out = vals[0].to(home)
    for v in vals[1:]:
        out = out + v.to(home)
    return out


def global_bundle_adjust(poses: torch.Tensor, fixed: torch.Tensor,
                         points: torch.Tensor, point_valid: torch.Tensor,
                         obs: BAObservations, K: cam.PinholeK, iters: int = 8,
                         cg_iters: int = 40, chi2_th: float = robust.CHI2_MONO,
                         lam0=1e-3,
                         point_fixed: Optional[torch.Tensor] = None) -> GBAResult:
    """poses (Kc, 4, 4) T_cw; fixed (Kc,) bool gauge/lock mask; points
    (P, 3); obs the observation list with K per observation or shared.

    point_fixed: optional (P,) bool landmarks held constant; their
    observations act as pose-only factors (J_pt zeroed, step zero). lam0:
    the starting LM damping, a float or the `lam` of a previous slice."""
    return _solve(poses, fixed, points, point_valid, [_shard(obs, K)], iters,
                  cg_iters, chi2_th, lam0, point_fixed)


def _solve(poses, fixed, points, point_valid, shards, iters, cg_iters, chi2_th,
           lam0, point_fixed) -> GBAResult:
    """The LM-damped Schur solve over observation shards; each landmark's
    rows must lie in one shard. Camera-side state lives on poses.device."""
    Kc = poses.shape[0]
    P = points.shape[0]
    home, dt = poses.device, poses.dtype
    free = (~fixed).to(dt)[:, None]
    eye6 = torch.eye(6, dtype=dt, device=home)
    devs = list(dict.fromkeys(sh.kf.device for sh in shards))
    pv = {d: point_valid.to(d) for d in devs}
    pt_free = [None if point_fixed is None else
               (~point_fixed.to(sh.pt.device))[sh.pt].to(dt)[:, None, None]
               for sh in shards]

    def scatter(n, idx, vals):
        return torch.zeros((n,) + vals.shape[1:], dtype=dt, device=vals.device).index_add(
            0, idx, vals)

    def replicate(po, pts):
        return {d: (po.to(d), pts.to(d)) for d in devs}

    def mean_chi2(po, pts):
        rep = replicate(po, pts)
        sums, counts = [], []
        for sh in shards:
            r, _, _, behind = _obs_terms(*rep[sh.kf.device], sh.obs, sh.K)
            c2 = _chi2(r, sh.obs.inv_sigma2)
            ok = sh.obs.valid & ~behind
            counts.append(torch.sum(ok.to(torch.int32)))
            sums.append(torch.sum(torch.where(ok, torch.clamp(c2, max=chi2_th), 0.0)))
        return _reduce(sums, home) / torch.clamp(_reduce(counts, home), min=1)

    def gn_step(poses_, points_, lam, c_cur):
        rep = replicate(poses_, points_)
        loc, hcc, bc = [], [], []
        for sh, pf in zip(shards, pt_free):
            d = sh.kf.device
            r, J_cam, J_pt, behind = _obs_terms(*rep[d], sh.obs, sh.K)
            if pf is not None:
                J_pt = J_pt * pf
            c2 = _chi2(r, sh.obs.inv_sigma2)
            w = robust.huber_weight(c2, chi2_th) * sh.obs.inv_sigma2
            w = torch.where(sh.obs.valid & ~behind, w, 0.0)
            Jc_w = J_cam * w[:, None, None]
            Jp_w = J_pt * w[:, None, None]
            hcc.append(scatter(Kc, sh.kf, torch.einsum("ori,orj->oij", J_cam, Jc_w)))
            bc.append(scatter(Kc, sh.kf, torch.einsum("ori,or->oi", Jc_w, r)))
            # landmark side: every landmark's rows are in this shard
            Hpp = scatter(P, sh.pt, torch.einsum("ori,orj->oij", J_pt, Jp_w))
            b_p = scatter(P, sh.pt, torch.einsum("ori,or->oi", Jp_w, r))
            hpp_diag = torch.diagonal(Hpp, dim1=-2, dim2=-1)
            pt_seen = (hpp_diag.sum(-1) > 1e-9) & pv[d]
            eye3 = torch.eye(3, dtype=dt, device=d)
            Hpp_d = Hpp + lam.to(d) * torch.clamp(hpp_diag.mean(-1), min=1e-3)[:, None, None] \
                * eye3
            C_inv = inv3x3(torch.where(pt_seen[:, None, None], Hpp_d, eye3))
            loc.append((sh, J_cam, J_pt, Jc_w, Jp_w, b_p, pt_seen, C_inv))
        Hcc = _reduce(hcc, home)
        b_c = _reduce(bc, home)
        hcc_diag = torch.diagonal(Hcc, dim1=-2, dim2=-1)
        Hcc_d = Hcc + lam * torch.clamp(hcc_diag.mean(-1), min=1e-3)[:, None, None] * eye6

        def Et_x(part, x):        # (Kc, 6) -> (P, 3), this shard's landmarks
            sh, J_cam, _, _, Jp_w = part[:5]
            t = torch.einsum("ori,oi->or", J_cam, x[sh.kf])
            return scatter(P, sh.pt, torch.einsum("ori,or->oi", Jp_w, t))

        def E_y(part, y):         # (P, 3) -> (Kc, 6), this shard's rows
            sh, _, J_pt, Jc_w = part[:4]
            t = torch.einsum("ori,oi->or", J_pt, y[sh.pt])
            return scatter(Kc, sh.kf, torch.einsum("ori,or->oi", Jc_w, t))

        def S_mv(x):        # reduced-camera matvec, fixed cameras projected out
            x = x * free
            hx = torch.einsum("kij,kj->ki", Hcc_d, x)
            ex = _reduce([E_y(q, torch.einsum("pab,pb->pa", q[7], Et_x(q, x.to(q[0].kf.device))))
                          for q in loc], home)
            return (hx - ex) * free

        rhs = -(b_c - _reduce([E_y(q, torch.einsum("pab,pb->pa", q[7], q[5]))
                               for q in loc], home)) * free
        M_inv = torch.linalg.inv_ex(Hcc_d + 1e-6 * eye6)[0]

        def prec(x):
            return torch.einsum("kij,kj->ki", M_inv, x) * free

        x = torch.zeros((Kc, 6), dtype=dt, device=home)
        rr = rhs - S_mv(x)
        z = prec(rr)
        p = z
        for _ in range(cg_iters):
            Sp = S_mv(p)
            denom = torch.sum(p * Sp)
            rz = torch.sum(rr * z)
            alpha = rz / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
            x = x + alpha * p
            rr = rr - alpha * Sp
            z = prec(rr)
            beta = torch.sum(rr * z) / torch.clamp(rz, min=1e-12)
            p = z + beta * p
        dc = x
        # each landmark's step comes from its own shard (zero elsewhere)
        dps = []
        for q in loc:
            dp_s = -torch.einsum("pab,pb->pa", q[7], q[5] + Et_x(q, dc.to(q[0].kf.device)))
            dps.append(torch.where(q[6][:, None], dp_s, 0.0))
        dp = _reduce(dps, home)
        finite = torch.isfinite(dc).all() & torch.isfinite(dp).all()
        dc = torch.where(finite, dc, 0.0)
        dp = torch.where(finite, dp, 0.0)
        new_poses = se3.normalize(se3.retract(poses_, dc))
        new_points = points_ + dp
        c_new = mean_chi2(new_poses, new_points)
        accept = finite & (c_new <= c_cur)
        return (torch.where(accept, new_poses, poses_),
                torch.where(accept, new_points, points_),
                torch.where(accept, torch.clamp(lam * 0.4, min=1e-6),
                            torch.clamp(lam * 8.0, max=1e3)),
                torch.where(accept, c_new, c_cur))

    chi2_in = mean_chi2(poses, points)
    lam = (lam0.to(home, torch.float32) if isinstance(lam0, torch.Tensor)
           else torch.full((), float(lam0), dtype=torch.float32, device=home))
    state = (poses, points, lam, chi2_in)
    for _ in range(iters):
        state = gn_step(*state)
    poses_f, points_f, lam_f, chi2 = state
    return GBAResult(poses=poses_f, points=points_f, chi2=chi2, chi2_in=chi2_in,
                     lam=lam_f)


def shard_rows(pt: np.ndarray, n_points: int, n: int):
    """Host bucketing of the observation rows by landmark owner, the JAX
    entry's: owner = pt * n // n_points, rows stably sorted by owner.
    Returns one index array of rows a shard (the JAX code pads each to
    the longest with masked rows, a jit shape that adds zero)."""
    owner = np.clip((pt.astype(np.int64) * n) // max(n_points, 1), 0, n - 1)
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return [order[bounds[d]:bounds[d + 1]] for d in range(n)]


def cuda_devices() -> list:
    """Every visible CUDA device (the sharded entry's default)."""
    if not torch.cuda.is_available():
        raise RuntimeError("global_bundle_adjust_sharded: no CUDA device is visible; "
                           "pass devices= to shard over the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def global_bundle_adjust_sharded(poses, fixed, points, point_valid, obs: BAObservations,
                                 K: cam.PinholeK, iters: int = 8, cg_iters: int = 40,
                                 devices=None, force_shard: bool = False,
                                 point_fixed=None) -> GBAResult:
    """The global BA over an observation list sharded by landmark owner
    across `devices` (None: every visible CUDA device; a device may
    repeat). One device without force_shard runs global_bundle_adjust.
    Results, like the camera-side solve, live on poses.device."""
    devices = [torch.device(d) for d in (cuda_devices() if devices is None else devices)]
    n = len(devices)
    if n == 1 and not force_shard:
        return global_bundle_adjust(poses, fixed, points, point_valid, obs, K,
                                    iters=iters, cg_iters=cg_iters,
                                    point_fixed=point_fixed)
    rows = shard_rows(obs.pt.cpu().numpy(), points.shape[0], n)
    batched_K = K.fx.dim() > 0
    shards = []
    for d, r in zip(devices, rows):
        idx = torch.from_numpy(r).to(obs.kf.device)
        o = BAObservations(*(None if f is None else f[idx].to(d) for f in obs))
        k = cam.PinholeK(*((f[idx] if batched_K else f).to(d) for f in K))
        shards.append(_shard(o, k))
    return _solve(poses, fixed, points, point_valid, shards, iters, cg_iters,
                  robust.CHI2_MONO, 1e-3, point_fixed)
