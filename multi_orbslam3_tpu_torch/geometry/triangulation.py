"""Batched two-view triangulation + checks (counterpart of
multi_orbslam3_tpu/geometry/triangulation.py). Validity is a mask, never a
data-dependent shape."""

from __future__ import annotations

from typing import Tuple

import torch

from multi_orbslam3_tpu_torch.geometry import camera as cam

_EPS = 1e-8


def triangulate_dlt(T1: torch.Tensor, T2: torch.Tensor,
                    bearing1: torch.Tensor, bearing2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation: T* (..., 4, 4) camera-from-world, bearing*
    (..., 3) -> (..., 3). Smallest eigenvector of A^T A by eight shifted
    inverse-power iterations (as the JAX package)."""
    def rows(T, b):
        P = T[..., :3, :4]
        r1 = b[..., 0, None] * P[..., 2, :] - P[..., 0, :]
        r2 = b[..., 1, None] * P[..., 2, :] - P[..., 1, :]
        return r1, r2

    a1, a2 = rows(T1, bearing1)
    a3, a4 = rows(T2, bearing2)
    A = torch.stack([a1, a2, a3, a4], dim=-2)
    AtA = A.transpose(-1, -2) @ A
    eye = torch.eye(4, dtype=A.dtype, device=A.device)
    tr = AtA.diagonal(dim1=-2, dim2=-1).sum(-1)
    M = AtA + 1e-6 * tr[..., None, None] * eye
    x = torch.ones(A.shape[:-2] + (4,), dtype=A.dtype, device=A.device)
    for _ in range(8):
        x = torch.linalg.solve_ex(M, x[..., None])[0][..., 0]
        x = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + _EPS)
    w = x[..., 3]
    w_safe = torch.where(torch.abs(w) < _EPS, torch.full_like(w, _EPS), w)
    return x[..., :3] / w_safe[..., None]


def depth_in(T: torch.Tensor, p_world: torch.Tensor) -> torch.Tensor:
    """Depth of world points in camera T (camera-from-world)."""
    return (torch.einsum("...ij,...j->...i", T[..., :3, :3], p_world)
            + T[..., :3, 3])[..., 2]


def parallax_cos(T1: torch.Tensor, T2: torch.Tensor,
                 p_world: torch.Tensor) -> torch.Tensor:
    """Cosine of the ray parallax angle."""
    c1 = -torch.einsum("...ji,...j->...i", T1[..., :3, :3], T1[..., :3, 3])
    c2 = -torch.einsum("...ji,...j->...i", T2[..., :3, :3], T2[..., :3, 3])
    r1 = p_world - c1
    r2 = p_world - c2
    num = torch.sum(r1 * r2, dim=-1)
    den = torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1) + _EPS
    return num / den


def triangulate_and_check(T1, T2, bearing1, bearing2, K, uv1, uv2,
                          max_reproj_err: float = 5.991,
                          min_parallax_cos: float = 0.9998,
                          K2=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triangulate + validity cascade (positive depth in both views,
    reprojection chi2 within threshold, enough parallax) as a mask."""
    p = triangulate_dlt(T1, T2, bearing1, bearing2)
    z1 = depth_in(T1, p)
    z2 = depth_in(T2, p)
    pc1 = torch.einsum("...ij,...j->...i", T1[..., :3, :3], p) + T1[..., :3, 3]
    pc2 = torch.einsum("...ij,...j->...i", T2[..., :3, :3], p) + T2[..., :3, 3]
    e1 = cam.project(K, pc1) - uv1
    e2 = cam.project(K if K2 is None else K2, pc2) - uv2
    err1 = torch.sum(e1 * e1, dim=-1)
    err2 = torch.sum(e2 * e2, dim=-1)
    cosp = parallax_cos(T1, T2, p)
    ok = ((z1 > _EPS) & (z2 > _EPS)
          & (err1 < max_reproj_err) & (err2 < max_reproj_err)
          & (cosp < min_parallax_cos) & torch.isfinite(p).all(dim=-1))
    return p, ok
