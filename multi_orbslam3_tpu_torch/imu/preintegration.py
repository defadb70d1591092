"""On-manifold IMU preintegration (counterpart of
multi_orbslam3_tpu/imu/preintegration.py).

A window is a fixed-capacity batch of (acc, gyro, dt) samples; padding has
dt = 0 and integrates to the identity. Tracked state: delta R/v/p, the five
bias Jacobians, the 9x9 covariance (order phi, v, p) and the integration
time.

The JAX package folds the samples with a scan of S steps. Here the window
is integrated without a loop over the samples: with the biases constant
over the window, every recursion of the scan is linear in the carried
state, so it is a prefix product of the per-sample rotations (and, for the
covariance, of the per-sample 9x9 transition matrices), taken in
log2(S) batched steps, followed by cumulative sums. A padding sample
contributes an identity factor and a zero term, so it leaves the state
exactly as it was.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from multi_orbslam3_tpu_torch.geometry import so3


class ImuCalib(NamedTuple):
    gyro_noise2: float      # sigma^2 * rate (discrete, applied per dt)
    acc_noise2: float
    gyro_walk2: float
    acc_walk2: float
    T_bc: torch.Tensor      # (4, 4) body-from-camera extrinsics
    gravity: float          # magnitude

    @classmethod
    def from_config(cls, imu_cfg, device=None) -> "ImuCalib":
        T_bc = torch.tensor(np.asarray(imu_cfg.T_bc, np.float32).reshape(4, 4),
                            device=device)
        return cls(gyro_noise2=imu_cfg.gyro_noise ** 2 * imu_cfg.rate_hz,
                   acc_noise2=imu_cfg.acc_noise ** 2 * imu_cfg.rate_hz,
                   gyro_walk2=imu_cfg.gyro_walk ** 2,
                   acc_walk2=imu_cfg.acc_walk ** 2,
                   T_bc=T_bc, gravity=float(imu_cfg.gravity))


class Preintegrated(NamedTuple):
    dR: torch.Tensor        # (3, 3)
    dV: torch.Tensor        # (3,)
    dP: torch.Tensor        # (3,)
    JRg: torch.Tensor       # (3, 3) d dR / d bg
    JVg: torch.Tensor       # (3, 3)
    JVa: torch.Tensor       # (3, 3)
    JPg: torch.Tensor       # (3, 3)
    JPa: torch.Tensor       # (3, 3)
    cov: torch.Tensor       # (9, 9) order (phi, v, p)
    dT: torch.Tensor        # () total time
    bg: torch.Tensor        # (3,) gyro bias used at integration
    ba: torch.Tensor        # (3,) acc bias used at integration


def empty_preintegrated(bg=None, ba=None, device=None) -> Preintegrated:
    if bg is not None:
        device = bg.device
    z3 = torch.zeros(3, device=device)
    z33 = torch.zeros((3, 3), device=device)
    return Preintegrated(dR=torch.eye(3, device=device), dV=z3, dP=z3, JRg=z33,
                         JVg=z33, JVa=z33, JPg=z33, JPa=z33,
                         cov=torch.zeros((9, 9), device=device),
                         dT=torch.zeros((), device=device),
                         bg=z3 if bg is None else bg,
                         ba=z3 if ba is None else ba)


def stack_preintegrated(items) -> Preintegrated:
    """A sequence of windows as one Preintegrated with a leading axis."""
    return Preintegrated(*(torch.stack(f) for f in zip(*items)))


def index_preintegrated(p: Preintegrated, i) -> Preintegrated:
    return Preintegrated(*(f[i] for f in p))


def _prefix_products(M: torch.Tensor) -> torch.Tensor:
    """P[k] = M[0] @ M[1] @ ... @ M[k] for (S, n, n), in log2(S) steps."""
    P, d = M, 1
    while d < M.shape[0]:
        P = torch.cat([P[:d], P[:-d] @ P[d:]])
        d *= 2
    return P


def _exclusive_cumsum(x: torch.Tensor):
    """(sum of the rows before each row, sum of all rows)."""
    c = torch.cumsum(x, 0)
    return c - x, c[-1]


def preintegrate(acc: torch.Tensor, gyro: torch.Tensor, dt: torch.Tensor,
                 bg: torch.Tensor, ba: torch.Tensor,
                 calib: ImuCalib) -> Preintegrated:
    """acc/gyro: (S, 3); dt: (S,) with zeros for padding slots. Runs on the
    device of its inputs and reads nothing back."""
    dev, dtype = acc.device, acc.dtype
    S = acc.shape[0]
    h = torch.where(dt > 0.0, dt, 0.0)
    h1, h2 = h[:, None], h[:, None, None]
    a = acc - ba
    wh = (gyro - bg) * h1
    dRk = so3.exp(wh)                                   # (S, 3, 3)
    Jr = so3.right_jacobian(wh)
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(S, 3, 3)
    zero3 = torch.zeros((S, 3, 3), dtype=dtype, device=dev)

    # rotation before (dR_k) and after (dR_{k+1}) each sample
    dR_post = _prefix_products(dRk)
    dR_pre = torch.cat([eye3[:1], dR_post[:-1]])
    Ra = torch.einsum("sij,sj->si", dR_pre, a)
    dV_pre, dV = _exclusive_cumsum(Ra * h1)
    dP = torch.sum(dV_pre * h1 + 0.5 * Ra * h1 * h1, 0)
    JVa_pre, JVa = _exclusive_cumsum(-dR_pre * h2)
    JPa = torch.sum(JVa_pre * h2 - 0.5 * dR_pre * h2 * h2, 0)
    # JRg_{k+1} = dRk_k^T JRg_k - Jr_k h_k; with JRg_k = dR_k^T G_k this is
    # G_{k+1} = G_k - dR_{k+1} Jr_k h_k
    G_pre, G = _exclusive_cumsum(-(dR_post @ Jr) * h2)
    JRg_pre = dR_pre.transpose(-1, -2) @ G_pre
    JRg = dR_post[-1].T @ G
    Ra_hat = dR_pre @ so3.hat(a)
    M = Ra_hat @ JRg_pre
    JVg_pre, JVg = _exclusive_cumsum(-M * h2)
    JPg = torch.sum(JVg_pre * h2 - 0.5 * M * h2 * h2, 0)

    # covariance: cov_{k+1} = A_k cov_k A_k^T + B_k Q_k B_k^T from cov_0 = 0
    # is sum_k Phi_k N_k Phi_k^T with Phi_k = A_{S-1} ... A_{k+1}
    A = torch.cat([
        torch.cat([dRk.transpose(-1, -2), zero3, zero3], -1),
        torch.cat([-Ra_hat * h2, eye3, zero3], -1),
        torch.cat([-0.5 * Ra_hat * h2 * h2, eye3 * h2, eye3], -1)], -2)
    B = torch.cat([
        torch.cat([Jr * h2, zero3], -1),
        torch.cat([zero3, dR_pre * h2], -1),
        torch.cat([zero3, 0.5 * dR_pre * h2 * h2], -1)], -2)
    q = torch.cat([torch.full((3,), calib.gyro_noise2, dtype=dtype, device=dev),
                   torch.full((3,), calib.acc_noise2, dtype=dtype, device=dev)])
    N = (B * (q * torch.clamp(h, min=1e-9)[:, None])[:, None, :]) @ B.transpose(-1, -2)
    eye9 = torch.eye(9, dtype=dtype, device=dev)[None]
    Phi = torch.cat([eye9, _prefix_products(A.flip(0))[:-1]]).flip(0)
    cov = torch.sum(Phi @ N @ Phi.transpose(-1, -2), 0)
    return Preintegrated(dR=dR_post[-1], dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
                         JPg=JPg, JPa=JPa, cov=cov, dT=torch.sum(h), bg=bg, ba=ba)


def bias_corrected_delta(p: Preintegrated, bg: torch.Tensor, ba: torch.Tensor):
    """First-order delta update for a new bias."""
    dbg = bg - p.bg
    dba = ba - p.ba
    dR = p.dR @ so3.exp(p.JRg @ dbg)
    dV = p.dV + p.JVg @ dbg + p.JVa @ dba
    dP = p.dP + p.JPg @ dbg + p.JPa @ dba
    return dR, dV, dP


def predict_state(R_wb: torch.Tensor, v_w: torch.Tensor, p_w: torch.Tensor,
                  preint: Preintegrated, gravity_w: torch.Tensor,
                  bg: torch.Tensor, ba: torch.Tensor):
    """Propagate a world-frame body state through a preintegration window."""
    dR, dV, dP = bias_corrected_delta(preint, bg, ba)
    t = preint.dT
    R2 = R_wb @ dR
    v2 = v_w + gravity_w * t + R_wb @ dV
    p2 = p_w + v_w * t + 0.5 * gravity_w * t * t + R_wb @ dP
    return R2, v2, p2


def merge_preintegrated(p1: Preintegrated, p2: Preintegrated) -> Preintegrated:
    """Compose two consecutive windows. The merged window is stamped with
    p1's bias, so p2's deltas are first corrected to it to first order."""
    dR2, dV2, dP2 = bias_corrected_delta(p2, p1.bg, p1.ba)
    dR = p1.dR @ dR2
    dV = p1.dV + p1.dR @ dV2
    dP = p1.dP + p1.dV * p2.dT + p1.dR @ dP2
    # jacobian composition (first order, at the corrected deltas)
    JRg = dR2.T @ p1.JRg + p2.JRg
    JVg = p1.JVg + p1.dR @ p2.JVg - p1.dR @ so3.hat(dV2) @ p1.JRg
    JVa = p1.JVa + p1.dR @ p2.JVa
    JPg = p1.JPg + p1.JVg * p2.dT + p1.dR @ p2.JPg \
        - p1.dR @ so3.hat(dP2) @ p1.JRg
    JPa = p1.JPa + p1.JVa * p2.dT + p1.dR @ p2.JPa
    # covariance: transport p1's through p2's window + add p2's
    eye3 = torch.eye(3, dtype=dR.dtype, device=dR.device)
    zero3 = torch.zeros_like(eye3)
    A = torch.cat([
        torch.cat([dR2.T, zero3, zero3], -1),
        torch.cat([-p1.dR @ so3.hat(dV2), eye3, zero3], -1),
        torch.cat([-p1.dR @ so3.hat(dP2), eye3 * p2.dT, eye3], -1)], -2)
    cov = A @ p1.cov @ A.T + p2.cov
    return Preintegrated(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
                         JPg=JPg, JPa=JPa, cov=cov, dT=p1.dT + p2.dT,
                         bg=p1.bg, ba=p1.ba)


# ----------------------------------------------------------------------
# wire flattening (the preintegration uplink of the collaborative mode)
# ----------------------------------------------------------------------
FLAT_DIM = 148  # dR 9 + dV 3 + dP 3 + 5 Jacobians 45 + cov 81 + dT 1 +
#                 bg 3 + ba 3
FLAT_DT = 141   # offset of dT within a flat row (9+3+3+45+81)
FLAT_BG = 142   # offset of bg (3,)
FLAT_BA = 145   # offset of ba (3,)
_FLAT_SHAPES = ((3, 3), (3,), (3,), (3, 3), (3, 3), (3, 3), (3, 3), (3, 3),
                (9, 9), (), (3,), (3,))


def preint_to_flat(p: Preintegrated) -> np.ndarray:
    """Flatten one Preintegrated into a (FLAT_DIM,) float32 row."""
    return torch.cat([f.reshape(-1) for f in p]).cpu().numpy().astype(np.float32)


def flat_to_preint(row, device=None) -> Preintegrated:
    """Inverse of preint_to_flat (accepts a numpy array or a tensor). Rows
    (..., FLAT_DIM) give a Preintegrated with those leading axes."""
    r = torch.as_tensor(row, dtype=torch.float32, device=device)
    sizes = [int(np.prod(s)) for s in _FLAT_SHAPES]
    lead = tuple(r.shape[:-1])
    return Preintegrated(*(part.reshape(lead + s) for part, s in
                           zip(torch.split(r, sizes, dim=-1), _FLAT_SHAPES)))
