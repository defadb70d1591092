"""Batched ORB descriptor matching (counterpart of
multi_orbslam3_tpu/frontend/matcher.py): every search is a dense masked
Hamming-distance problem; the distance matrix comes from kernel K2.

Thresholds mirror the reference: TH_LOW = 50, TH_HIGH = 100, Lowe ratio,
30-bin rotation-consistency histogram keeping the top 3 bins.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from multi_orbslam3_tpu_torch.frontend import kernels
from multi_orbslam3_tpu_torch.frontend.extractor import topk_stable

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30
BIG = 10_000


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) int32 words -> (N, M) int32 Hamming distances
    (kernel K2 on the GPU, its plain version on the CPU)."""
    return kernels.hamming_matrix(d1.contiguous(), d2.contiguous())


def best_two(dist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row best index (first on ties), best and second-best distance."""
    best_idx = torch.argmin(dist, dim=1)
    best = torch.gather(dist, 1, best_idx[:, None])[:, 0]
    masked = dist.scatter(1, best_idx[:, None], BIG)
    return best_idx, best, torch.amin(masked, dim=1)


def rotation_consistency(angle_diff: torch.Tensor, valid: torch.Tensor,
                         keep_bins: int = 3) -> torch.Tensor:
    """Keep matches whose angle difference falls in the `keep_bins` most
    popular of 30 histogram bins (ties: lower bin first, as top_k)."""
    frac = torch.remainder(angle_diff / (2.0 * math.pi), 1.0)
    bins = torch.clamp((frac * HISTO_BINS).to(torch.int64), 0, HISTO_BINS - 1)
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=bins.device)
    hist = hist.index_add(0, bins, valid.to(torch.int32))
    _, top = topk_stable(hist, keep_bins)
    in_top = torch.any(bins[:, None] == top[None, :], dim=1)
    return valid & in_top


class MatchResult(NamedTuple):
    idx: torch.Tensor    # (N,) int64 index into the second set, -1 unmatched
    dist: torch.Tensor   # (N,) int32 Hamming distance (BIG if unmatched)

    @property
    def valid(self) -> torch.Tensor:
        return self.idx >= 0

    @property
    def count(self) -> torch.Tensor:
        return torch.sum(self.idx >= 0)


def match_mutual(desc1: torch.Tensor, valid1: torch.Tensor,
                 desc2: torch.Tensor, valid2: torch.Tensor,
                 max_dist: int = TH_LOW, ratio: float = 0.9,
                 angle1: torch.Tensor | None = None,
                 angle2: torch.Tensor | None = None) -> MatchResult:
    """Mutual nearest neighbours with the Lowe ratio and optional rotation
    consistency (the reference's SearchForInitialization pattern)."""
    dist = hamming_matrix(desc1, desc2)
    dist = torch.where(valid1[:, None] & valid2[None, :], dist, BIG)
    idx12, best12, second12 = best_two(dist)
    idx21 = torch.argmin(dist, dim=0)
    rows = torch.arange(dist.shape[0], device=dist.device)
    mutual = idx21[idx12] == rows
    ok = (best12 <= max_dist) & (best12 <= ratio * second12) & mutual
    if angle1 is not None and angle2 is not None:
        ok = rotation_consistency(angle1 - angle2[idx12], ok)
    return MatchResult(torch.where(ok, idx12, -1), torch.where(ok, best12, BIG))


def match_by_projection(proj_uv: torch.Tensor, proj_valid: torch.Tensor,
                        mp_desc: torch.Tensor,
                        feat_uv: torch.Tensor, feat_valid: torch.Tensor,
                        feat_desc: torch.Tensor, feat_level: torch.Tensor,
                        radius: torch.Tensor, pred_level: torch.Tensor,
                        max_dist: int = TH_HIGH, ratio: float = 0.9,
                        level_slack: int = 1) -> MatchResult:
    """Guided search: for each projected map point (rows), the best feature
    (cols) within `radius` px and a predicted-octave window (reference
    SearchByProjection). radius: (M,) tensor or float."""
    d2 = torch.sum((proj_uv[:, None, :] - feat_uv[None, :, :]) ** 2, dim=-1)
    if isinstance(radius, torch.Tensor):
        r = radius.expand(proj_uv.shape[0])
    else:
        r = torch.full((proj_uv.shape[0],), float(radius), device=proj_uv.device)
    in_radius = d2 <= (r[:, None] ** 2)
    lv_ok = torch.abs(feat_level[None, :] - pred_level[:, None]) <= level_slack
    mask = in_radius & lv_ok & proj_valid[:, None] & feat_valid[None, :]
    dist = torch.where(mask, hamming_matrix(mp_desc, feat_desc), BIG)
    idx, best, second = best_two(dist)
    ok = (best <= max_dist) & ((best <= ratio * second) | (second >= BIG))
    return MatchResult(torch.where(ok, idx, -1), torch.where(ok, best, BIG))


def resolve_duplicate_targets(res: MatchResult, n_targets: int) -> MatchResult:
    """One-to-one assignment: where several rows matched the same target,
    keep the row with the smallest distance, then the first such row."""
    n_rows = res.idx.shape[0]
    dev = res.idx.device
    tgt = torch.where(res.idx >= 0, res.idx, n_targets)   # park invalid at n
    best_per_tgt = torch.full((n_targets + 1,), BIG, dtype=torch.int32, device=dev)
    best_per_tgt = best_per_tgt.scatter_reduce(0, tgt, res.dist, "amin",
                                               include_self=True)
    keep = (res.idx >= 0) & (res.dist <= best_per_tgt[tgt])
    rows = torch.arange(n_rows, device=dev)
    first_row = torch.full((n_targets + 1,), n_rows, dtype=torch.int64, device=dev)
    first_row = first_row.scatter_reduce(0, torch.where(keep, tgt, n_targets),
                                         rows, "amin", include_self=True)
    keep = keep & (first_row[tgt] == rows)
    return MatchResult(torch.where(keep, res.idx, -1),
                       torch.where(keep, res.dist, BIG))
