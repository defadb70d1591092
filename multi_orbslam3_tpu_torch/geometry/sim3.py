"""Sim(3) similarity transforms (counterpart of
multi_orbslam3_tpu/geometry/sim3.py), stored as (R: (..., 3, 3),
t: (..., 3), s: (...)).

The group action is x -> s R x + t, and composition S1 * S2 applies S2
first. The pose-graph tangent is zeta = (omega, v, sigma) in R^7 with the
left retraction exp(zeta) * S. Every small-angle and small-scale guard of
the JAX version is kept as a ``torch.where``: the pose graph
differentiates through them at zeta = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_orbslam3_tpu_torch.geometry import se3, so3

_EPS = 1e-8
_SMALL = 1e-4


class Sim3(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)
    s: torch.Tensor  # (...)


def identity(batch_shape=(), dtype=torch.float32, device=None) -> Sim3:
    b = tuple(batch_shape)
    return Sim3(torch.eye(3, dtype=dtype, device=device).expand(b + (3, 3)),
                torch.zeros(b + (3,), dtype=dtype, device=device),
                torch.ones(b, dtype=dtype, device=device))


def from_se3(T: torch.Tensor, s=None) -> Sim3:
    if s is None:
        s = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
    return Sim3(T[..., :3, :3], T[..., :3, 3], s)


def to_se3_scaled(S: Sim3) -> torch.Tensor:
    """SE3 [R | t / s]: the scale folded into the translation, as the
    reference applies a Sim3 correction to an SE3 pose."""
    return se3.make(S.R, S.t / S.s[..., None])


def _rot(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return (R @ p[..., None])[..., 0]


def apply(S: Sim3, p: torch.Tensor) -> torch.Tensor:
    return S.s[..., None] * _rot(S.R, p) + S.t


def compose(A: Sim3, B: Sim3) -> Sim3:
    """A * B: apply B first."""
    return Sim3(A.R @ B.R, A.s[..., None] * _rot(A.R, B.t) + A.t, A.s * B.s)


def inverse(S: Sim3) -> Sim3:
    Rt = S.R.transpose(-1, -2)
    inv_s = 1.0 / S.s
    return Sim3(Rt, -inv_s[..., None] * _rot(Rt, S.t), inv_s)


def _w_matrix(w: torch.Tensor, sigma: torch.Tensor,
              s: torch.Tensor) -> torch.Tensor:
    """Strasdat's similarity 'W' matrix A I + B W + C W^2 (s = e^sigma),
    with the JAX version's branch guards."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = so3.hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    small_s = torch.abs(sigma) < _SMALL
    small_t = theta < _SMALL
    c0 = torch.where(small_s, 1.0 - sigma / 2.0 + sigma * sigma / 6.0,
                     (s - 1.0) / torch.where(small_s, torch.ones_like(sigma), sigma))
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    denom = sigma * sigma + theta2
    a_coef = (s * sin_t) * sigma + (1.0 - s * cos_t) * theta
    both = small_t & small_s
    B = torch.where(both, torch.full_like(sigma, 0.5),
                    a_coef / (theta * torch.where(both, torch.ones_like(denom),
                                                  denom) + _EPS))
    c_coef = torch.where(
        small_s,
        torch.where(small_t, torch.full_like(sigma, 1.0 / 6.0),
                    (theta - sin_t) / (theta2 * theta + _EPS)),
        (c0 - ((s * cos_t - 1.0) * sigma + s * sin_t * theta) / (denom + _EPS))
        / (theta2 + _EPS))
    return (c0[..., None, None] * eye + B[..., None, None] * W
            + c_coef[..., None, None] * (W @ W))


def exp(zeta: torch.Tensor) -> Sim3:
    """(..., 7) (omega, v, sigma) -> Sim3."""
    w, v, sigma = zeta[..., :3], zeta[..., 3:6], zeta[..., 6]
    s = torch.exp(sigma)
    return Sim3(so3.exp(w), _rot(_w_matrix(w, sigma, s), v), s)


def log(S: Sim3) -> torch.Tensor:
    """Sim3 -> (..., 7): the inverse of exp, solving the 3x3 W system.
    The solve goes through inv_ex: the pose graph differentiates log
    under vmap(jacfwd), where linalg.solve's forward-mode derivative is
    wrong for every batch row but the first (PyTorch 2.13)."""
    w = so3.log(S.R)
    sigma = torch.log(S.s)
    v = _rot(torch.linalg.inv_ex(_w_matrix(w, sigma, S.s))[0], S.t)
    return torch.cat([w, v, sigma[..., None]], dim=-1)


def retract(S: Sim3, zeta: torch.Tensor) -> Sim3:
    return compose(exp(zeta), S)


def stack(S: Sim3) -> torch.Tensor:
    """Pack to (..., 13) [R(9), t(3), s] for array storage."""
    return torch.cat([S.R.reshape(S.R.shape[:-2] + (9,)), S.t, S.s[..., None]],
                     dim=-1)


def unstack(x: torch.Tensor) -> Sim3:
    return Sim3(x[..., :9].reshape(x.shape[:-1] + (3, 3)), x[..., 9:12],
                x[..., 12])
