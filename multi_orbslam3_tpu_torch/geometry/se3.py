"""SE(3) rigid transforms as (..., 4, 4) homogeneous T_cw matrices
(counterpart of multi_orbslam3_tpu/geometry/se3.py).

Tangent convention: xi = (omega, v) with rotation first;
exp(xi) = [[exp(omega), Jl(omega) v], [0, 1]].
"""

from __future__ import annotations

import torch

from multi_orbslam3_tpu_torch.geometry import so3


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # the [0, 0, 0, 1] row is cut from an identity made on the device: a
    # host constant (or a scalar assignment) would copy and stall the stream
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(
        tuple(batch_shape) + (4, 4))


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rotation(T).transpose(-1, -2)
    return make(Rt, -torch.einsum("...ij,...j->...i", Rt, translation(T)))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points: (..., 4, 4) x (..., 3) -> (..., 3)."""
    return torch.einsum("...ij,...j->...i", rotation(T), p) + translation(T)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) tangent (omega, v) -> (..., 4, 4)."""
    w = xi[..., :3]
    v = xi[..., 3:]
    Jl = so3.right_jacobian(-w)
    return make(so3.exp(w), torch.einsum("...ij,...j->...i", Jl, v))


def log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) tangent (omega, v)."""
    w = so3.log(rotation(T))
    Jl_inv = so3.right_jacobian_inv(-w)
    v = torch.einsum("...ij,...j->...i", Jl_inv, translation(T))
    return torch.cat([w, v], dim=-1)


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction used by all optimizers: exp(xi) * T."""
    return compose(exp(xi), T)


def normalize(T: torch.Tensor) -> torch.Tensor:
    """Re-orthogonalize the rotation block (float32 drift control)."""
    return make(so3.normalize_rotation(rotation(T)), translation(T))
