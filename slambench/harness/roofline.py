"""The least time one H100 could take for a K1 or K2 launch, from what its
inputs need: a frozen copy of the port's chip_smoke.py arithmetic (bound,
compass_pass_count, window_pairs, projection_bound, valid_bound, as of this
benchmark's first commit), so that a later kernel that skips work cannot
change the yardstick.

Peaks: one H100 SXM's HBM rate and dense int8 tensor rate from NVIDIA's
data sheet; float32 and min/max instructions a clock an SM from the CUDA
documentation's arithmetic-throughput table for compute capability 9.0.
The SM count and the card's maximum SM clock are read from the card."""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_CLK_SM = 128
MINMAX_PER_CLK_SM = 64
INT8_TENSOR_OPS_PER_S = 1979e12


def bound_ms(card: dict, nbytes: float, hamming_pairs: float = 0.0,
             fp32_instr: float = 0.0, minmax_instr: float = 0.0) -> float:
    """The largest of the bytes over the HBM rate, the Hamming distances on
    the int8 tensor cores (2 x 256 operations a pair) and the float
    instructions over their rates, in ms."""
    clk = card["sm_count"] * card["max_sm_clock_hz"]
    return 1e3 * max(nbytes / HBM_BYTES_PER_S,
                     2.0 * 256.0 * hamming_pairs / INT8_TENSOR_OPS_PER_S,
                     (fp32_instr / FP32_INSTR_PER_CLK_SM
                      + minmax_instr / MINMAX_PER_CLK_SM) / clk)


def compass_pass_count(levels, threshold: float) -> tuple:
    """(interior pixels, pixels that need K1's arc search): those with at
    least 2 of the 4 compass pixels of the radius-3 circle beyond the
    threshold on one side."""
    interior = passing = 0
    for im in levels:
        c = im[3:-3, 3:-3]
        d = torch.stack([im[6:, 3:-3] - c, im[3:-3, 6:] - c,
                         im[:-6, 3:-3] - c, im[3:-3, :-6] - c])
        need = ((d > threshold).sum(0) >= 2) | ((-d > threshold).sum(0) >= 2)
        interior += c.numel()
        passing += int(need.sum())
    return interior, passing


def k1_bound_ms(card: dict, levels, threshold: float) -> float:
    """K1 over these levels: 4 bytes read and 4 written a pixel, 16
    differences and 8 compass compares an interior pixel, 158 min/max more
    where the arc search runs."""
    interior, passing = compass_pass_count(levels, threshold)
    pixels = sum(im.numel() for im in levels)
    return bound_ms(card, 8.0 * pixels, fp32_instr=16.0 * interior,
                    minmax_instr=8.0 * interior + 158.0 * passing)


def window_pairs(proj_uv, proj_valid, radius, pred_level, feat_uv, feat_valid,
                 feat_level, level_slack: int) -> float:
    """The pairs a projection match's inputs need: both valid, inside the
    radius and the level window."""
    n = proj_uv.shape[0]
    r = radius.expand(n) if isinstance(radius, torch.Tensor) else torch.full(
        (n,), float(radius), device=proj_uv.device)
    total = 0
    for r0 in range(0, n, 4096):
        sl = slice(r0, r0 + 4096)
        d2 = torch.sum((proj_uv[sl, None, :] - feat_uv[None, :, :]) ** 2, dim=-1)
        total += int(((d2 <= r[sl, None] ** 2)
                      & ((feat_level[None, :] - pred_level[sl, None]).abs() <= level_slack)
                      & proj_valid[sl, None] & feat_valid[None, :]).sum())
    return float(total)


def projection_bound_ms(card: dict, mp_desc, proj_uv, proj_valid, radius, pred_level,
                        feat_desc, feat_uv, feat_valid, feat_level, level_slack) -> float:
    """Every row's and column's flag; of the valid rows the descriptor,
    position, level and radius; of the valid columns descriptor, position
    and level; 16 output bytes a row; the distances of the window pairs."""
    n, m = proj_uv.shape[0], feat_uv.shape[0]
    nv, mv = float(proj_valid.sum()), float(feat_valid.sum())
    per_row = isinstance(radius, torch.Tensor) and radius.numel() == n
    row_bytes = 32.0 + 8.0 + 4.0 + (4.0 if per_row else 0.0)
    nbytes = n + m + nv * row_bytes + (0.0 if per_row else 4.0) + mv * 44.0 + 16.0 * n
    return bound_ms(card, nbytes, hamming_pairs=window_pairs(
        proj_uv, proj_valid, radius, pred_level, feat_uv, feat_valid, feat_level,
        level_slack))


def valid_bound_ms(card: dict, v1: torch.Tensor, v2: torch.Tensor) -> float:
    """Every flag, the descriptors of the valid rows and columns, 16 output
    bytes a row and 8 a column, the distances of the valid pairs."""
    n, m = v1.shape[0], v2.shape[0]
    nv, mv = float(v1.sum()), float(v2.sum())
    return bound_ms(card, n + m + 32.0 * (nv + mv) + 16.0 * n + 8.0 * m,
                    hamming_pairs=nv * mv)
