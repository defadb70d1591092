"""Windowed bundle adjustment with a dense-E Schur complement (counterpart
of multi_orbslam3_tpu/opt/local_ba.py):

    Hcc (Kw,6,6), Hpp (Pw,3,3), E (Kw,Pw,6,3) by scatter-adds over the
    observations (or, with grouped=True, block sums and one-hot matmuls);
    S = blockdiag(Hcc) - E C^-1 E^T is one (6Kw x 3Pw) x (3Pw x 6Kw)
    matmul; dc = solve(S, -rhs); dp = -C^-1 (b_p + E^T dc).

Levenberg damping with step rejection over a fixed number of iterations;
no value is read back to the host. Stereo observations (u_r >= 0) add a
third residual row and take the 3-dof chi2 threshold.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import se3
from multi_orbslam3_tpu_torch.opt import robust
from multi_orbslam3_tpu_torch.opt.pose_opt import (point_jacobian_se3,
                                                  projection_terms)


class BAObservations(NamedTuple):
    """Fixed-capacity observation list: window-local keyframe kf (O,),
    window-local landmark pt (O,), measured uv (O, 2), information
    inv_sigma2 (O,), mask valid (O,), and optionally the stereo right-u
    u_r (O,), -1 on monocular observations."""

    kf: torch.Tensor
    pt: torch.Tensor
    uv: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor
    u_r: Optional[torch.Tensor] = None


class BAResult(NamedTuple):
    poses: torch.Tensor     # (Kw, 4, 4)
    points: torch.Tensor    # (Pw, 3)
    inliers: torch.Tensor   # (O,) bool
    chi2: torch.Tensor      # () mean inlier chi2


def _obs_terms(poses, points, obs: BAObservations, K: cam.PinholeK, bf=0.0):
    T = poses[obs.kf]
    p_c = se3.apply(T, points[obs.pt])
    r, Jproj = projection_terms(K, p_c, obs.uv, obs.u_r, bf)
    J_cam = Jproj @ point_jacobian_se3(p_c)
    J_pt = Jproj @ T[..., :3, :3]
    return r, J_cam, J_pt, p_c[..., 2] <= 1e-3


def _chi2(r: torch.Tensor, inv_sigma2: torch.Tensor) -> torch.Tensor:
    """Per-observation chi2: squared residual norm times information."""
    return torch.sum(r * r, dim=-1) * inv_sigma2


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1e-20)
    adj = torch.stack([
        torch.stack([c00, c10, c20], -1),
        torch.stack([c01, c11, c21], -1),
        torch.stack([c02, c12, c22], -1)], -2)
    return adj * inv_det[..., None, None]


# elements of one one-hot block of the grouped assembly: 64 MiB in float32,
# 4 keyframes of a 1,024-feature, 4,096-landmark window a matmul
_ONEHOT_ELEMS = 1 << 24


def onehot_blocks(pt_k: torch.Tensor, prod: torch.Tensor, Pw: int) -> torch.Tensor:
    """The landmark-side sums of the grouped assembly (counterpart of the
    JAX package's _grouped_point_blocks): pt_k (Kw,N) landmark indices of
    each window keyframe's observations, prod (Kw,N,C) their products ->
    (Kw,Pw,C), keyframe k's one-hot (N,Pw) transposed times its products.
    Zero-weight rows carry zero products, so no masking is needed. The
    (c,N,Pw) one-hot of c keyframes at a time stays within _ONEHOT_ELEMS."""
    Kw, N = pt_k.shape
    cols = torch.arange(Pw, device=pt_k.device)
    c = max(1, _ONEHOT_ELEMS // (N * Pw))
    return torch.cat([
        torch.bmm((pt_k[k:k + c, :, None] == cols).to(prod.dtype).transpose(1, 2),
                  prod[k:k + c]) for k in range(0, Kw, c)])


def bundle_adjust(poses: torch.Tensor, fixed: torch.Tensor, points: torch.Tensor,
                  obs: BAObservations, K: cam.PinholeK, iters: int = 10,
                  chi2_th: float = robust.CHI2_MONO, structure_only: bool = False,
                  bf=0.0, grouped: bool = False) -> BAResult:
    """poses (Kw,4,4) T_cw; fixed (Kw,) bool anchors; points (Pw,3); bf =
    baseline * fx, used only when obs.u_r is present.

    structure_only: each step moves the seen landmarks by -C^-1 b_p and
    leaves the poses as they are. grouped: the observations are laid out
    (Kw, N) row-major (obs.kf == repeat(arange(Kw), N)); Hcc and b_c are
    then block sums and E, Hpp and b_p one-hot matmuls in place of the
    scatter-adds."""
    Kw = poses.shape[0]
    Pw = points.shape[0]
    dev, dt = poses.device, poses.dtype
    free = ~fixed
    fm = free.to(dt)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    kf = obs.kf.long()
    pt = obs.pt.long()
    if obs.u_r is not None:
        chi2_th = torch.where(obs.u_r >= 0, robust.CHI2_STEREO, chi2_th)

    def energy(poses_, points_):
        r, _, _, behind = _obs_terms(poses_, points_, obs, K, bf)
        c2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        rho = torch.where(c2 <= chi2_th, c2,
                          2.0 * torch.sqrt(chi2_th * torch.clamp(c2, min=0.0))
                          - chi2_th)
        return torch.sum(torch.where(obs.valid & ~behind, rho, 0.0))

    def step(poses_, points_, lam):
        r, J_cam, J_pt, behind = _obs_terms(poses_, points_, obs, K, bf)
        c2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        w = robust.huber_weight(c2, chi2_th) * obs.inv_sigma2
        w = torch.where(obs.valid & ~behind, w, 0.0)
        Jc_w = J_cam * w[:, None, None]
        Jp_w = J_pt * w[:, None, None]
        prod_Hpp = torch.einsum("ori,orj->oij", J_pt, Jp_w)
        prod_bp = torch.einsum("ori,or->oi", Jp_w, r)

        if grouped and not structure_only:
            N = pt.shape[0] // Kw
            Hcc = torch.einsum("ori,orj->oij", J_cam, Jc_w).reshape(Kw, N, 6, 6).sum(1)
            b_c = torch.einsum("ori,or->oi", Jc_w, r).reshape(Kw, N, 6).sum(1)
            blocks = onehot_blocks(pt.reshape(Kw, N), torch.cat([
                torch.einsum("ori,orj->oij", Jc_w, J_pt).reshape(Kw, N, 18),
                prod_Hpp.reshape(Kw, N, 9), prod_bp.reshape(Kw, N, 3)], -1), Pw)
            E = blocks[..., :18].reshape(Kw, Pw, 6, 3)
            rest = blocks[..., 18:].sum(0)
            Hpp, b_p = rest[:, :9].reshape(Pw, 3, 3), rest[:, 9:]
        else:
            Hpp = torch.zeros((Pw, 3, 3), dtype=dt, device=dev).index_add(0, pt, prod_Hpp)
            b_p = torch.zeros((Pw, 3), dtype=dt, device=dev).index_add(0, pt, prod_bp)
            if not structure_only:
                Hcc = torch.zeros((Kw, 6, 6), dtype=dt, device=dev).index_add(
                    0, kf, torch.einsum("ori,orj->oij", J_cam, Jc_w))
                b_c = torch.zeros((Kw, 6), dtype=dt, device=dev).index_add(
                    0, kf, torch.einsum("ori,or->oi", Jc_w, r))
                E = torch.zeros((Kw * Pw, 6, 3), dtype=dt, device=dev).index_add(
                    0, kf * Pw + pt, torch.einsum("ori,orj->oij", Jc_w, J_pt)
                ).reshape(Kw, Pw, 6, 3)

        hpp_diag = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        Hpp_d = Hpp + lam * eye3 * torch.clamp(hpp_diag.mean(-1), min=1e-3)[:, None, None]
        pt_seen = hpp_diag.sum(-1) > 1e-9
        C_inv = inv3x3(torch.where(pt_seen[:, None, None], Hpp_d, eye3))
        if structure_only:
            dp = -torch.einsum("pab,pb->pa", C_inv, b_p)
            return poses_, points_ + torch.where(pt_seen[:, None], dp, 0.0)

        EC = torch.einsum("kpab,pbc->kpac", E, C_inv)             # (Kw,Pw,6,3)
        A = EC.permute(0, 2, 1, 3).reshape(Kw * 6, Pw * 3)
        B = E.permute(0, 2, 1, 3).reshape(Kw * 6, Pw * 3)
        S = -(A @ B.T).reshape(Kw, 6, Kw, 6)
        hcc_diag = torch.diagonal(Hcc, dim1=-2, dim2=-1)
        blocks = Hcc + lam * eye6 * torch.clamp(hcc_diag.mean(-1), min=1e-3)[:, None, None]
        S = _add_diag_blocks(S, blocks)
        rhs = b_c - torch.einsum("kpac,pc->ka", EC, b_p)
        # clamp fixed cameras: identity rows/cols, zero rhs
        S = S * fm[:, None, None, None] * fm[None, None, :, None]
        S = _add_diag_blocks(S, (1.0 - fm)[:, None, None] * eye6)
        rhs = rhs * fm[:, None]

        Sf = S.reshape(Kw * 6, Kw * 6) + 1e-8 * torch.eye(Kw * 6, dtype=dt, device=dev)
        dc = torch.linalg.solve_ex(Sf, -rhs.reshape(-1))[0].reshape(Kw, 6)
        dc = torch.where(free[:, None], dc, 0.0)
        Et_dc = torch.einsum("kpac,ka->pc", E, dc)
        dp = -torch.einsum("pab,pb->pa", C_inv, b_p + Et_dc)
        dp = torch.where(pt_seen[:, None], dp, 0.0)
        finite = torch.isfinite(dc).all() & torch.isfinite(dp).all()
        dc = torch.where(finite, dc, 0.0)
        dp = torch.where(finite, dp, 0.0)
        return se3.normalize(se3.retract(poses_, dc)), points_ + dp

    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    e_prev = energy(poses, points)
    for _ in range(iters):
        p2, x2 = step(poses, points, lam)
        e_new = energy(p2, x2)
        accept = e_new < e_prev
        poses = torch.where(accept, p2, poses)
        points = torch.where(accept, x2, points)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-6),
                          torch.clamp(lam * 4.0, max=1e2))
        e_prev = torch.where(accept, e_new, e_prev)

    r, _, _, behind = _obs_terms(poses, points, obs, K, bf)
    c2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    inliers = obs.valid & ~behind & (c2 <= chi2_th)
    n_in = torch.clamp(torch.sum(inliers.to(torch.int32)), min=1)
    return BAResult(poses=poses, points=points, inliers=inliers,
                    chi2=torch.sum(torch.where(inliers, c2, 0.0)) / n_in)


def _add_diag_blocks(S: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """S (Kw,6,Kw,6) + block-diagonal `blocks` (Kw,6,6), out of place."""
    Kw = S.shape[0]
    bd = torch.zeros_like(S)
    idx = torch.arange(Kw, device=S.device)
    bd[idx, :, idx, :] = blocks       # fresh tensor: in place is safe
    return S + bd
