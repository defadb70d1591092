"""Dense FAST-9/16 corner score and 3x3 NMS (counterpart of
multi_orbslam3_tpu/frontend/fast.py).

These are the plain forms: 16 zero-padded shifted copies of the level, the
arc minimums and a shifted-max NMS. ``frontend/kernels.py`` runs the same
computation as one hand-written CUDA kernel on the GPU and uses these
functions as its plain version on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 — the 16 (dx, dy) offsets in contiguous
# order (identical to the JAX package's fast._CIRCLE).
CIRCLE = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)
ARC_LEN = 9


def shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], zero-padded."""
    h, w = img.shape
    py = (max(0, -dy), max(0, dy))
    px = (max(0, -dx), max(0, dx))
    p = F.pad(img, (px[0], px[1], py[0], py[1]))
    return p[py[0] + dy: py[0] + dy + h, px[0] + dx: px[0] + dx + w]


def border_mask(h: int, w: int, width: int, device) -> torch.Tensor:
    """(h, w) bool: True within `width` px of the image edge."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys < width) | (ys >= h - width) | (xs < width) | (xs >= w - width)


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-pixel FAST-9/16 score: max over the 16 length-9 arcs of the
    arc's min bright (or dark) difference; 0 unless > threshold; 0 on the
    3-px border."""
    diffs = torch.stack([shift2d(img, dy, dx) - img for (dx, dy) in CIRCLE])
    circ_b = torch.cat([diffs, diffs[:ARC_LEN - 1]], dim=0)
    circ_d = -circ_b
    min_b = circ_b[:16]
    min_d = circ_d[:16]
    for i in range(1, ARC_LEN):
        min_b = torch.minimum(min_b, circ_b[i:i + 16])
        min_d = torch.minimum(min_d, circ_d[i:i + 16])
    score = torch.maximum(min_b.amax(0), min_d.amax(0))
    zero = torch.zeros_like(score)
    score = torch.where(score > threshold, score, zero)
    h, w = img.shape
    return torch.where(border_mask(h, w, 3, img.device), zero, score)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep 3x3 local maxima: strictly greater than the earlier neighbours
    and >= the later ones, so a plateau yields one peak."""
    earlier_max = None
    later_max = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = shift2d(score, dy, dx)
            if (dy, dx) < (0, 0):
                earlier_max = n if earlier_max is None else torch.maximum(earlier_max, n)
            else:
                later_max = n if later_max is None else torch.maximum(later_max, n)
    keep = (score > earlier_max) & (score >= later_max)
    return torch.where(keep, score, torch.zeros_like(score))
