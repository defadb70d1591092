"""Monocular two-view bootstrap via batched E/H RANSAC (counterpart of
multi_orbslam3_tpu/pipeline/initializer.py): a fixed batch of 8-point
essential and 4-point homography hypotheses scored in parallel, model
selection by relative support, refinement on inliers, cheirality over the
candidate motions, triangulation.

Hypotheses draw from a ``torch.Generator`` (on the data's device), so the
samples differ from the JAX package's key stream; results agree
statistically, not hypothesis for hypothesis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_orbslam3_tpu_torch.geometry import camera as cam
from multi_orbslam3_tpu_torch.geometry import se3, triangulation


class InitResult(NamedTuple):
    ok: torch.Tensor          # () bool
    T_21: torch.Tensor        # (4, 4) pose of view 2 in view-1 frame (unit baseline)
    points: torch.Tensor      # (M, 3) landmarks in view-1 frame
    point_ok: torch.Tensor    # (M,) bool
    inliers: torch.Tensor     # (M,) bool epipolar inliers
    n_inliers: torch.Tensor   # () int32


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """(..., R, 9) -> (..., 9): right singular vector of the smallest
    singular value."""
    full = A.shape[-2] < A.shape[-1]
    return torch.linalg.svd(A, full_matrices=full)[2][..., -1, :]


def _epipolar_rows(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    x1, y1 = b1[..., 0], b1[..., 1]
    x2, y2 = b2[..., 0], b2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def _project_essential(E: torch.Tensor) -> torch.Tensor:
    """Two equal singular values, the third zero."""
    U, S, Vt = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    d = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return U @ torch.diag_embed(d) @ Vt


def _homography_rows(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    x1, y1 = b1[..., 0], b1[..., 1]
    x2, y2 = b2[..., 0], b2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rows_a = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    rows_b = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], dim=-1)
    return rows_a, rows_b


def _sampson_err(E: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Sampson error of b2^T E b1; E (..., 3, 3), b (M, 3) -> (..., M)."""
    Eb1 = b1 @ E.transpose(-1, -2)
    Etb2 = b2 @ E
    num = torch.sum(b2 * Eb1, dim=-1) ** 2
    den = Eb1[..., 0] ** 2 + Eb1[..., 1] ** 2 + Etb2[..., 0] ** 2 + Etb2[..., 1] ** 2
    return num / (den + 1e-12)


def _h_transfer_err(H: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Symmetric transfer error of H (..., 3, 3) on the unit plane."""
    Hb1 = b1 @ H.transpose(-1, -2)
    p12 = Hb1[..., :2] / (Hb1[..., 2:3] + 1e-12)
    Hinv_b2 = b2 @ torch.linalg.inv_ex(H)[0].transpose(-1, -2)
    p21 = Hinv_b2[..., :2] / (Hinv_b2[..., 2:3] + 1e-12)
    return (torch.sum((p12 - b2[..., :2]) ** 2, dim=-1)
            + torch.sum((p21 - b1[..., :2]) ** 2, dim=-1))


def _decompose_H(H: torch.Tensor):
    """Faugeras decomposition into the 8 candidate (R, t), |t| = 1."""
    U, d, Vt = torch.linalg.svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / denom)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / denom)
    x1s = (aux1, aux1, -aux1, -aux1)
    x3s = (aux3, -aux3, aux3, -aux3)
    num = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    sin_t = num / torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    sin_p = num / torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rs, ts = [], []
    for i, eps in enumerate((1.0, -1.0, -1.0, 1.0)):     # case d' = +d2
        st = eps * sin_t
        Rp = mat([[cos_t, zero, -st], [zero, one, zero], [st, zero, cos_t]])
        Rs.append(s * (U @ Rp @ Vt))
        ts.append(U @ ((d1 - d3) * torch.stack([x1s[i], zero, -x3s[i]])))
    for i, eps in enumerate((1.0, -1.0, -1.0, 1.0)):     # case d' = -d2
        sp = eps * sin_p
        Rp = mat([[cos_p, zero, sp], [zero, -one, zero], [sp, zero, -cos_p]])
        Rs.append(s * (U @ Rp @ Vt))
        ts.append(U @ ((d1 + d3) * torch.stack([x1s[i], zero, x3s[i]])))
    ts = torch.stack(ts)
    return torch.stack(Rs), ts / (torch.linalg.norm(ts, dim=-1, keepdim=True) + 1e-12)


def _decompose_E(E: torch.Tensor):
    """E -> 4 candidate (R, t) with |t| = 1."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.zeros((3, 3), dtype=E.dtype, device=E.device)
    W[0, 1], W[1, 0], W[2, 2] = -1.0, 1.0, 1.0
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def sample_hypotheses(match_valid: torch.Tensor, n_hyp: int, k: int,
                      generator: torch.Generator) -> torch.Tensor:
    """(n_hyp, k) indices, each row k distinct valid matches drawn
    uniformly (random keys, invalid matches keyed below every valid one)."""
    keys = torch.rand((n_hyp, match_valid.shape[0]), generator=generator,
                      device=match_valid.device)
    keys = torch.where(match_valid[None, :], keys, -1.0)
    return torch.topk(keys, k, dim=1).indices


def initialize_two_view(K: cam.PinholeK, uv1: torch.Tensor, uv2: torch.Tensor,
                        match_valid: torch.Tensor, generator: torch.Generator,
                        n_hyp: int = 192, inlier_th_px: float = 1.5,
                        min_inliers: int = 50,
                        min_parallax_cos: float = 0.99995) -> InitResult:
    """uv1/uv2: (M, 2) matched undistorted pixels; match_valid (M,)."""
    M = uv1.shape[0]
    b1 = cam.unproject(K, uv1)
    b2 = cam.unproject(K, uv2)
    f = (K.fx + K.fy) * 0.5
    th = (inlier_th_px / f) ** 2

    # hypothesis batch: E (8-pt) and H (first 4 of the same samples)
    idx = sample_hypotheses(match_valid, n_hyp, 8, generator)
    Es = _project_essential(
        _null_vector(_epipolar_rows(b1[idx], b2[idx])).reshape(n_hyp, 3, 3))
    inl = (_sampson_err(Es, b1, b2) < th) & match_valid[None, :]
    inliers = inl[torch.argmax(inl.sum(1))]

    ra, rb = _homography_rows(b1[idx[:, :4]], b2[idx[:, :4]])
    Hs = _null_vector(torch.cat([ra, rb], dim=1)).reshape(n_hyp, 3, 3)
    inl_h = (_h_transfer_err(Hs, b1, b2) < 2.0 * th) & match_valid[None, :]
    inliers_h = inl_h[torch.argmax(inl_h.sum(1))]

    nH = inliers_h.sum().float()
    nE = inliers.sum().float()
    use_h = nH / torch.clamp(nH + nE, min=1.0) > 0.45

    # refine E and H on their inliers (weighted DLT over all M)
    E = _project_essential(
        _null_vector(_epipolar_rows(b1, b2) * inliers[:, None]).reshape(3, 3))
    inliers_e = (_sampson_err(E, b1, b2) < th) & match_valid
    ra, rb = _homography_rows(b1, b2)
    w_h = inliers_h[:, None].to(ra.dtype)
    H = _null_vector(torch.cat([ra * w_h, rb * w_h], dim=0)).reshape(3, 3)
    inliers_h = (_h_transfer_err(H, b1, b2) < 2.0 * th) & match_valid
    inliers = torch.where(use_h, inliers_h, inliers_e)

    # cheirality over the winning model's candidates (E's 4 repeated to 8)
    Rs_e, ts_e = _decompose_E(E)
    Rs_h, ts_h = _decompose_H(H)
    Rs = torch.where(use_h, Rs_h, torch.cat([Rs_e, Rs_e]))
    ts = torch.where(use_h, ts_h, torch.cat([ts_e, ts_e]))
    T2 = se3.make(Rs, ts)                                   # (8, 4, 4)
    T1 = se3.identity((8, M), device=uv1.device)
    T2b = T2[:, None].expand(8, M, 4, 4)
    p = triangulation.triangulate_dlt(T1, T2b, b1.expand(8, M, 3),
                                      b2.expand(8, M, 3))   # (8, M, 3)
    good = ((p[..., 2] > 1e-3) & (triangulation.depth_in(T2b, p) > 1e-3)
            & inliers[None, :])
    counts = good.sum(1)
    pick = torch.argmax(counts)
    points = p[pick]
    front = good[pick]
    T21 = T2[pick]

    cosp = triangulation.parallax_cos(T1[0], T21.expand(M, 4, 4), points)
    enough_par = ((cosp < min_parallax_cos) & front).sum() >= (min_inliers // 2)
    n_in = front.sum().to(torch.int32)
    dominant = counts[pick] > 0.7 * torch.clamp(inliers.sum(), min=1)
    ok = (n_in >= min_inliers) & enough_par & dominant
    return InitResult(ok=ok, T_21=T21, points=points,
                      point_ok=front & (cosp < min_parallax_cos),
                      inliers=inliers, n_inliers=n_in)
