"""Global bundle adjustment on one device: implicit Schur complement and
PCG (counterpart of multi_orbslam3_tpu/opt/global_ba.py,
``global_bundle_adjust``).

The reduced camera system S = Hcc - E C^-1 E^T is never formed: every PCG
iteration applies S to a vector through observation-level gather, compute
and scatter passes (each O(observations)), preconditioned by the inverted
damped camera blocks. Levenberg-Marquardt step control accepts a
Gauss-Newton step only if it does not raise the mean bounded chi2; the
decision stays on the device (torch.where), so a call reads nothing back.

Plain PyTorch: the JAX version has no Pallas kernel, its products and
scatters are XLA ops. The scatters are index_add, which on a GPU adds with
float atomics in the order the threads arrive, so results agree with the
CPU to rounding, not bit for bit. The sharded entry
(``global_bundle_adjust_sharded``) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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
    Kc = poses.shape[0]
    P = points.shape[0]
    dev, dt = poses.device, poses.dtype
    free = (~fixed).to(dt)[:, None]
    kf = obs.kf.long()
    pt = obs.pt.long()
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    pt_free = None if point_fixed is None else (~point_fixed)[pt].to(dt)[:, None, None]

    def mean_chi2(po, pts):
        r, _, _, behind = _obs_terms(po, pts, obs, K)
        c2 = _chi2(r, obs.inv_sigma2)
        ok = obs.valid & ~behind
        n = torch.clamp(torch.sum(ok.to(torch.int32)), min=1)
        return torch.sum(torch.where(ok, torch.clamp(c2, max=chi2_th), 0.0)) / n

    def scatter(n, idx, vals):
        return torch.zeros((n,) + vals.shape[1:], dtype=dt, device=dev).index_add(
            0, idx, vals)

    def gn_step(poses_, points_, lam, c_cur):
        r, J_cam, J_pt, behind = _obs_terms(poses_, points_, obs, K)
        if pt_free is not None:
            J_pt = J_pt * pt_free
        c2 = _chi2(r, obs.inv_sigma2)
        w = robust.huber_weight(c2, chi2_th) * obs.inv_sigma2
        w = torch.where(obs.valid & ~behind, w, 0.0)
        Jc_w = J_cam * w[:, None, None]
        Jp_w = J_pt * w[:, None, None]

        Hcc = scatter(Kc, kf, torch.einsum("ori,orj->oij", J_cam, Jc_w))
        b_c = scatter(Kc, kf, torch.einsum("ori,or->oi", Jc_w, r))
        Hpp = scatter(P, pt, torch.einsum("ori,orj->oij", J_pt, Jp_w))
        b_p = scatter(P, pt, torch.einsum("ori,or->oi", Jp_w, r))

        hpp_diag = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        pt_seen = (hpp_diag.sum(-1) > 1e-9) & point_valid
        Hpp_d = Hpp + lam * torch.clamp(hpp_diag.mean(-1), min=1e-3)[:, None, None] * eye3
        C_inv = inv3x3(torch.where(pt_seen[:, None, None], Hpp_d, eye3))
        hcc_diag = torch.diagonal(Hcc, dim1=-2, dim2=-1)
        Hcc_d = Hcc + lam * torch.clamp(hcc_diag.mean(-1), min=1e-3)[:, None, None] * eye6

        def Et_x(x):        # (Kc, 6) -> (P, 3)
            t = torch.einsum("ori,oi->or", J_cam, x[kf])
            return scatter(P, pt, torch.einsum("ori,or->oi", Jp_w, t))

        def E_y(y):         # (P, 3) -> (Kc, 6)
            t = torch.einsum("ori,oi->or", J_pt, y[pt])
            return scatter(Kc, kf, torch.einsum("ori,or->oi", Jc_w, t))

        def S_mv(x):        # reduced-camera matvec, fixed cameras projected out
            x = x * free
            hx = torch.einsum("kij,kj->ki", Hcc_d, x)
            ex = E_y(torch.einsum("pab,pb->pa", C_inv, Et_x(x)))
            return (hx - ex) * free

        rhs = -(b_c - E_y(torch.einsum("pab,pb->pa", C_inv, b_p))) * free
        M_inv = torch.linalg.inv_ex(Hcc_d + 1e-6 * eye6)[0]

        def prec(x):
            return torch.einsum("kij,kj->ki", M_inv, x) * free

        x = torch.zeros((Kc, 6), dtype=dt, device=dev)
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
        dp = -torch.einsum("pab,pb->pa", C_inv, b_p + Et_x(dc))
        dp = torch.where(pt_seen[:, None], dp, 0.0)
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
    lam = (lam0.to(dev, torch.float32) if isinstance(lam0, torch.Tensor)
           else torch.full((), float(lam0), dtype=torch.float32, device=dev))
    state = (poses, points, lam, chi2_in)
    for _ in range(iters):
        state = gn_step(*state)
    poses_f, points_f, lam_f, chi2 = state
    return GBAResult(poses=poses_f, points=points_f, chi2=chi2, chi2_in=chi2_in,
                     lam=lam_f)
