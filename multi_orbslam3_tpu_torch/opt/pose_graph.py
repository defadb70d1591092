"""Sim(3) pose-graph optimisation over the essential graph (counterpart of
multi_orbslam3_tpu/opt/pose_graph.py).

Nodes are Sim3 poses; each edge residual is r = log(S_ij * S_j * S_i^-1)
with Jacobians from ``torch.func.vmap(torch.func.jacfwd(...))`` at
delta = 0. The normal system is assembled from 7x7 blocks and solved
dense (one (K*7)^2 solve, 3584^2 at 512 keyframes) or, for large graphs,
by block-Jacobi preconditioned conjugate gradients that never build H.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_orbslam3_tpu_torch.geometry import sim3


class PoseGraphEdges(NamedTuple):
    """Fixed-capacity edge list. S_ij is the measured relative transform
    S_i * S_j^-1, so the residual vanishes at consistency."""

    i: torch.Tensor        # (E,) int
    j: torch.Tensor        # (E,) int
    S_ij: torch.Tensor     # (E, 13) packed Sim3
    weight: torch.Tensor   # (E,) float32
    valid: torch.Tensor    # (E,) bool


def make_edges(S_nodes: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
               weight: torch.Tensor, valid: torch.Tensor) -> PoseGraphEdges:
    """Measure the current relative transforms between node pairs."""
    Si = sim3.unstack(S_nodes[i.long()])
    Sj = sim3.unstack(S_nodes[j.long()])
    return PoseGraphEdges(i=i, j=j, S_ij=sim3.stack(sim3.compose(Si, sim3.inverse(Sj))),
                          weight=weight, valid=valid)


def _retract(S: sim3.Sim3, zeta: torch.Tensor, right: bool) -> sim3.Sim3:
    """Left (camera-frame) or right (world-frame) perturbation; the 4-DoF
    mode perturbs on the right, where rotation about z is world yaw."""
    if right:
        return sim3.compose(S, sim3.exp(zeta))
    return sim3.compose(sim3.exp(zeta), S)


def _edge_residual(S_ij_flat, Si_flat, Sj_flat, di, dj, right=False):
    Si = _retract(sim3.unstack(Si_flat), di, right)
    Sj = _retract(sim3.unstack(Sj_flat), dj, right)
    return sim3.log(sim3.compose(sim3.compose(sim3.unstack(S_ij_flat), Sj),
                                 sim3.inverse(Si)))


def edge_jacobians(edges: PoseGraphEdges, S_nodes: torch.Tensor,
                   right: bool = False):
    """Per-edge residual (E, 7) and Jacobians d r / d delta_i, d r /
    d delta_j (E, 7, 7), by forward-mode autodiff at delta = 0."""
    zero = torch.zeros(7, dtype=S_nodes.dtype, device=S_nodes.device)

    def res(S_ij_f, Si_f, Sj_f, di, dj):
        # each edge runs as a batch of one: forward AD of a 0-d tensor
        # with a Python float gives a float64 tangent (PyTorch 2.x)
        return _edge_residual(S_ij_f[None], Si_f[None], Sj_f[None], di[None],
                              dj[None], right)[0]

    def one(S_ij_f, Si_f, Sj_f):
        return (res(S_ij_f, Si_f, Sj_f, zero, zero),
                torch.func.jacfwd(res, argnums=3)(S_ij_f, Si_f, Sj_f, zero, zero),
                torch.func.jacfwd(res, argnums=4)(S_ij_f, Si_f, Sj_f, zero, zero))

    return torch.func.vmap(one)(edges.S_ij, S_nodes[edges.i.long()],
                                S_nodes[edges.j.long()])


def _block_add(shape, rows: torch.Tensor, cols, vals: torch.Tensor) -> torch.Tensor:
    """zeros(shape) with vals[e] added at [rows[e], cols[e]] (or at
    [rows[e]] when cols is None); duplicate indices accumulate."""
    idx = (rows,) if cols is None else (rows, cols)
    return torch.zeros(shape, dtype=vals.dtype, device=vals.device).index_put(
        idx, vals, accumulate=True)


def optimize_pose_graph(S_nodes: torch.Tensor, fixed: torch.Tensor,
                        edges: PoseGraphEdges, iters: int = 15,
                        fix_scale: bool = False, yaw_only: bool = False,
                        solver: str = "auto", cg_iters: int = 60) -> torch.Tensor:
    """S_nodes (K, 13) packed Sim3; fixed (K,) bool. Returns (K, 13).

    fix_scale freezes the scale DoF (6-DoF mode); yaw_only also freezes
    roll and pitch and perturbs on the right, so the corrected poses keep
    their gravity column. solver "dense" builds H as (K, K, 7, 7) blocks
    and solves (K*7)^2 directly; "cg" runs block-Jacobi PCG on the
    per-edge blocks; "auto" picks cg when K*7 > 4096."""
    K = S_nodes.shape[0]
    dev, dt = S_nodes.device, S_nodes.dtype
    if solver == "auto":
        solver = "cg" if K * 7 > 4096 else "dense"
    dof = torch.ones(7, dtype=dt, device=dev)
    if yaw_only:
        dof[:2] = 0.0                      # fresh tensor: in place is safe
    if fix_scale:
        dof[6] = 0.0
    free = (~fixed).to(dt)[:, None] * dof[None, :]                  # (K, 7)
    ei, ej = edges.i.long(), edges.j.long()
    w = torch.where(edges.valid, edges.weight, 0.0)

    S_cur = S_nodes
    for _ in range(iters):
        r, Ji, Jj = edge_jacobians(edges, S_cur, yaw_only)
        Jiw = Ji * w[:, None, None]
        Jjw = Jj * w[:, None, None]
        b = (_block_add((K, 7), ei, None, torch.einsum("eri,er->ei", Jiw, r))
             + _block_add((K, 7), ej, None, torch.einsum("eri,er->ei", Jjw, r)))
        bf = b * free
        Hii = torch.einsum("eri,erj->eij", Ji, Jiw)
        Hjj = torch.einsum("eri,erj->eij", Jj, Jjw)
        Hij = torch.einsum("eri,erj->eij", Ji, Jjw)
        Hji = torch.einsum("eri,erj->eij", Jj, Jiw)
        if solver == "dense":
            H = (_block_add((K, K, 7, 7), ei, ei, Hii)
                 + _block_add((K, K, 7, 7), ej, ej, Hjj)
                 + _block_add((K, K, 7, 7), ei, ej, Hij)
                 + _block_add((K, K, 7, 7), ej, ei, Hji))
            H = H.permute(0, 2, 1, 3) * free[:, :, None, None] * free[None, None]
            Hf = H.reshape(K * 7, K * 7)
            ff = free.reshape(-1)
            Hf = Hf + torch.diag(torch.where(ff > 0, 1e-6, 1.0))
            Hf = Hf + 1e-5 * torch.diag(torch.diagonal(Hf))
            d = torch.linalg.solve_ex(Hf, -bf.reshape(-1))[0].reshape(K, 7) * free
        else:
            D = _block_add((K, 7, 7), ei, None, Hii) + _block_add((K, 7, 7), ej, None, Hjj)
            D = D * free[:, :, None] * free[:, None, :]
            diag = torch.diagonal(D, dim1=-2, dim2=-1)
            D = D + torch.diag_embed(1e-5 * diag + torch.where(free > 0, 1e-6, 1.0))
            D_inv = torch.linalg.inv_ex(D)[0]

            def matvec(x):                                  # x: (K, 7)
                xm = x * free
                xi, xj = xm[ei], xm[ej]
                y = (_block_add((K, 7), ei, None, torch.einsum("eij,ej->ei", Hii, xi)
                                + torch.einsum("eij,ej->ei", Hij, xj))
                     + _block_add((K, 7), ej, None, torch.einsum("eij,ej->ei", Hjj, xj)
                                  + torch.einsum("eij,ej->ei", Hji, xi)))
                # damping, and the identity on clamped dims, keep it PD
                return (y * free + 1e-5 * (torch.abs(diag) + 1.0) * xm
                        + torch.where(free > 0, 0.0, 1.0) * x)

            def prec(x):
                return torch.einsum("kij,kj->ki", D_inv, x)

            x = torch.zeros((K, 7), dtype=dt, device=dev)
            rr = -bf
            z = prec(rr)
            p, rz = z, torch.sum(rr * z)
            for _ in range(cg_iters):
                Ap = matvec(p)
                alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
                x = x + alpha * p
                rr = rr - alpha * Ap
                z = prec(rr)
                rz_new = torch.sum(rr * z)
                p = z + rz_new / torch.clamp(rz, min=1e-20) * p
                rz = rz_new
            d = x * free
        d = torch.where(torch.isfinite(d), d, 0.0)
        S_cur = sim3.stack(_retract(sim3.unstack(S_cur), d, yaw_only))
    return S_cur
