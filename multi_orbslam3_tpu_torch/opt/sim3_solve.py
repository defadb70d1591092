"""Sim(3) estimation from 3D-3D correspondences (counterpart of
multi_orbslam3_tpu/opt/sim3_solve.py): batched Horn/Umeyama closed forms
inside a fixed-size RANSAC, IRLS refinement on the inliers, and the
two-way reprojection refinement of the verification cascade.

Hypotheses draw three distinct valid pairs each from the caller's
``torch.Generator`` (uniform over the valid pairs, which is what the JAX
package's ``choice(p=valid / sum(valid))`` is), so samples differ from
JAX's and outcomes agree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import se3, sim3
from multi_orbslam3_tpu_torch.geometry.sim3 import Sim3
from multi_orbslam3_tpu_torch.opt.robust import huber_weight
from multi_orbslam3_tpu_torch.pipeline.initializer import sample_hypotheses


def horn_sim3(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor | None = None,
              fix_scale: bool = False) -> Sim3:
    """Closed-form similarity q ~ s R p + t. p, q (..., M, 3); w optional
    (..., M) weights. det(U) det(Vt) fixes the reflection, so the sign
    conventions of the SVD cancel."""
    if w is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    wn = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-9)
    mu_p = torch.sum(wn[..., None] * p, dim=-2)
    mu_q = torch.sum(wn[..., None] * q, dim=-2)
    pc = p - mu_p[..., None, :]
    qc = q - mu_q[..., None, :]
    cov = torch.einsum("...m,...mi,...mj->...ij", wn, qc, pc)
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    one = torch.ones_like(det)
    S = torch.stack([one, one, torch.sign(det + 1e-12)], dim=-1)
    R = U @ (S[..., :, None] * Vt)
    var_p = torch.einsum("...m,...mi,...mi->...", wn, pc, pc)
    s = one if fix_scale else torch.sum(D * S, dim=-1) / (var_p + 1e-12)
    t = mu_q - s[..., None] * (R @ mu_p[..., None])[..., 0]
    return Sim3(R, t, s)


class Sim3RansacResult(NamedTuple):
    S: Sim3                   # best q <- p similarity
    inliers: torch.Tensor     # (M,) bool
    n_inliers: torch.Tensor   # () int32
    ok: torch.Tensor          # () bool


def _pick(S: Sim3, i: torch.Tensor) -> Sim3:
    """Hypothesis i (a 1-element index tensor) without a host read."""
    return Sim3(*(x.index_select(0, i)[0] for x in S))


def sim3_ransac(p: torch.Tensor, q: torch.Tensor, valid: torch.Tensor,
                generator: torch.Generator, n_hyp: int = 128,
                inlier_th=0.1, min_inliers: int = 20,
                fix_scale: bool = False,
                refine_iters: int = 4) -> Sim3RansacResult:
    """p, q (M, 3) corresponding points (candidate side, current side);
    inlier_th is a 3D distance in q's scale (a float or a 0-d tensor)."""
    idx = sample_hypotheses(valid, n_hyp, 3, generator)     # (H, 3)
    S_h = horn_sim3(p[idx], q[idx], fix_scale=fix_scale)
    S_b = Sim3(S_h.R[:, None], S_h.t[:, None], S_h.s[:, None])
    err = torch.linalg.norm(sim3.apply(S_b, p[None]) - q[None], dim=-1)
    inl = (err < inlier_th) & valid[None, :]
    best = torch.argmax(torch.sum(inl.to(torch.int32), dim=-1)).reshape(1)
    S_cur, inliers = _pick(S_h, best), inl.index_select(0, best)[0]
    # IRLS refinement: weighted Horn on the (soft) inliers
    for _ in range(refine_iters):
        e = torch.linalg.norm(sim3.apply(S_cur, p) - q, dim=-1)
        wgt = (valid & (e < inlier_th * 1.5)).to(p.dtype)
        S_cur = horn_sim3(p, q, wgt, fix_scale=fix_scale)
        inliers = wgt > 0
    n_in = torch.sum(inliers.to(torch.int32)).to(torch.int32)
    return Sim3RansacResult(S=S_cur, inliers=inliers, n_inliers=n_in,
                            ok=n_in >= min_inliers)


def optimize_sim3_reprojection(S0: Sim3, K: cam.PinholeK, T_cur: torch.Tensor,
                               T_cand: torch.Tensor, p_cand: torch.Tensor,
                               uv_cur: torch.Tensor, has_cur: torch.Tensor,
                               p_cur: torch.Tensor, uv_cand: torch.Tensor,
                               has_cand: torch.Tensor,
                               inv_sigma2_cur: torch.Tensor,
                               inv_sigma2_cand: torch.Tensor,
                               iters: int = 10, fix_scale: bool = False,
                               chi2_th: float = 9.21, K_cand=None):
    """Two-way reprojection refinement of p_cur ~ S(p_cand):

        r_fwd = project(K, T_cur . S(p_cand)) - uv_cur
        r_bwd = project(K_cand, T_cand . S^-1(p_cur)) - uv_cand

    Gauss-Newton over the 7-dim tangent, Huber weights (chi2 9.21),
    Jacobians by forward-mode autodiff at delta = 0. Returns
    (S_refined, inlier_fwd, inlier_bwd)."""
    if K_cand is None:
        K_cand = K
    dev, dt = p_cand.device, p_cand.dtype
    zero = torch.zeros(7, dtype=dt, device=dev)
    dof = torch.ones(7, dtype=dt, device=dev)
    if fix_scale:
        dof[6] = 0.0                       # fresh tensor: in place is safe
    eye7 = torch.eye(7, dtype=dt, device=dev)

    def residuals(d, S_flat):
        # a batch of one: forward AD of a 0-d tensor with a Python float
        # gives a float64 tangent (PyTorch 2.x)
        S = sim3.retract(sim3.unstack(S_flat[None]), d[None])
        pc_f = se3.apply(T_cur[None], sim3.apply(S, p_cand))
        pc_b = se3.apply(T_cand[None], sim3.apply(sim3.inverse(S), p_cur))
        return (cam.project(K, pc_f) - uv_cur, cam.project(K_cand, pc_b) - uv_cand,
                pc_f[..., 2] <= 1e-3, pc_b[..., 2] <= 1e-3)

    def chi2(r_f, r_b):
        return (torch.sum(r_f * r_f, -1) * inv_sigma2_cur,
                torch.sum(r_b * r_b, -1) * inv_sigma2_cand)

    S_flat = sim3.stack(S0)
    for _ in range(iters):
        r_f, r_b, bh_f, bh_b = residuals(zero, S_flat)
        J_f, J_b = torch.func.jacfwd(
            lambda d: residuals(d, S_flat)[:2])(zero)       # (M, 2, 7) each
        c2_f, c2_b = chi2(r_f, r_b)
        w_f = torch.where(has_cur & ~bh_f,
                          huber_weight(c2_f, chi2_th) * inv_sigma2_cur, 0.0)
        w_b = torch.where(has_cand & ~bh_b,
                          huber_weight(c2_b, chi2_th) * inv_sigma2_cand, 0.0)
        H = (torch.einsum("mri,m,mrj->ij", J_f, w_f, J_f)
             + torch.einsum("mri,m,mrj->ij", J_b, w_b, J_b))
        b = (torch.einsum("mri,m,mr->i", J_f, w_f, r_f)
             + torch.einsum("mri,m,mr->i", J_b, w_b, r_b))
        H = (H * dof[:, None] * dof[None, :] + torch.diag(torch.where(dof > 0, 0.0, 1.0))
             + 1e-3 * torch.diag(torch.diagonal(H)) + 1e-6 * eye7)
        dx = torch.linalg.solve_ex(H, -b)[0] * dof
        dx = torch.where(torch.isfinite(dx).all(), dx, zero)
        S_flat = sim3.stack(sim3.retract(sim3.unstack(S_flat), dx))
    r_f, r_b, bh_f, bh_b = residuals(zero, S_flat)
    c2_f, c2_b = chi2(r_f, r_b)
    inl_f = has_cur & ~bh_f & (c2_f <= chi2_th)
    inl_b = has_cand & ~bh_b & (c2_b <= chi2_th)
    return sim3.unstack(S_flat), inl_f, inl_b
