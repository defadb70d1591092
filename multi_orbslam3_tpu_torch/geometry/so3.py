"""SO(3) ops: hat/vee, exp/log, right Jacobian (counterpart of
multi_orbslam3_tpu/geometry/so3.py). All functions broadcast over leading
axes; Taylor fallbacks switch at theta ~ 1e-4 as in the JAX package."""

from __future__ import annotations

import torch

_EPS = 1e-8
_SMALL = 1e-4


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3) rotation matrix."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta < _SMALL
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    W = hat(w)
    return _eye3_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) rotation vector (near-pi axis from the
    diagonal of (R + I)/2, as the JAX package does)."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2)) * 0.5
    s2 = torch.sum(w_skew * w_skew, dim=-1)
    small = s2 < 1e-10
    s_safe = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = torch.atan2(s_safe, c)
    scale = torch.where(small, 1.0 + s2 / 6.0, theta / s_safe)
    w = scale[..., None] * w_skew

    near_pi = small & (c < 0.0)
    diag = R.diagonal(dim1=-2, dim2=-1)
    axis2 = torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0)
    axis = torch.sqrt(axis2 + _EPS)
    k = torch.argmax(axis2, dim=-1)
    sym = (R + R.transpose(-1, -2)) * 0.5
    col = torch.gather(sym, -1, k[..., None, None].expand(
        sym.shape[:-1] + (1,))).squeeze(-1)
    signs = torch.sign(col + _EPS * torch.ones_like(diag))
    axis_pi = axis * signs
    axis_pi = axis_pi / (torch.linalg.norm(axis_pi, dim=-1, keepdim=True) + _EPS)
    theta_pi = torch.atan2(torch.sqrt(s2 + 1e-20), c)
    return torch.where(near_pi[..., None], theta_pi[..., None] * axis_pi, w)


def right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Jr(w): d exp(w + dw) = exp(w) exp(Jr dw). (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta < _SMALL
    W = hat(w)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS))
    return _eye3_like(W) - b[..., None, None] * W + c[..., None, None] * (W @ W)


def right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Jr^{-1}(w) closed form."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta < _SMALL
    W = hat(w)
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        1.0 / (theta2 + _EPS)
        - (1.0 + torch.cos(theta)) / (2.0 * theta * torch.sin(theta) + _EPS))
    return _eye3_like(W) + 0.5 * W + cot_term[..., None, None] * (W @ W)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3) (two Newton steps of the
    polar decomposition, as the JAX package does)."""
    for _ in range(2):
        R = 1.5 * R - 0.5 * (R @ R.transpose(-1, -2)) @ R
    return R
