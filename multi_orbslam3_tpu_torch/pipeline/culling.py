"""Keyframe and landmark culling (counterpart of
multi_orbslam3_tpu/pipeline/culling.py).

A keyframe is redundant when at least 90% of its landmarks are seen by at
least 3 keyframes; a landmark is an orphan when it failed to gain
observations or its found/visible ratio fell below 0.25. Both are masked
reductions over the (K, P) observation mask. In the collaborative
topology culling runs on the server; clients never cull.
"""

from __future__ import annotations

from typing import Tuple

import torch

from multi_orbslam3_tpu_torch.map import mapstate as ms
from multi_orbslam3_tpu_torch.map.mapstate import MapState


def redundant_keyframes(m: MapState, protect: torch.Tensor,
                        redundancy: float = 0.9, min_obs: int = 3) -> torch.Tensor:
    """(K,) bool mask of cullable keyframes; `protect` marks keyframes that
    must stay (map origins, the newest ones, the current reference)."""
    obs = ms.kf_mp_mask(m)                                  # (K, P)
    counts = torch.sum(obs.to(torch.int32), dim=0)          # observations a point
    well_observed = counts >= min_obs
    per_kf_total = torch.sum(obs, dim=1)
    per_kf_red = torch.sum(obs & well_observed[None, :], dim=1)
    redundant = (per_kf_total > 0) & (per_kf_red >= redundancy * per_kf_total)
    return redundant & m.kf_valid & ~protect.to(m.device)


def orphan_mappoints(m: MapState, min_obs: int = 2, age_kf: int = 3) -> torch.Tensor:
    """(P,) bool mask of landmarks older than `age_kf` keyframes but
    observed by fewer than `min_obs`, or found in under a quarter of the
    frames that saw them (at least 8)."""
    obs = ms.kf_mp_mask(m)
    counts = torch.sum(obs.to(torch.int32), dim=0)
    old_enough = m.mp_ref_kf <= (m.n_kf - age_kf)
    under_observed = old_enough & (counts < min_obs)
    bad_ratio = (m.mp_visible >= 8) & (
        m.mp_found.to(torch.float32) < 0.25 * m.mp_visible.to(torch.float32))
    return m.mp_valid & (under_observed | bad_ratio)


def cull(m: MapState, protect_kf: torch.Tensor, max_kf_per_round: int = 4,
         age_kf: int = 3) -> Tuple[MapState, int, int]:
    """One culling round: erase the orphan landmarks, then up to
    `max_kf_per_round` redundant keyframes, lowest slots first. Returns
    (map, keyframes erased, landmarks erased); the counts are read back."""
    mp_mask = orphan_mappoints(m, age_kf=age_kf)
    n_mp = int(torch.sum(mp_mask))
    if n_mp > 0:
        slots = torch.where(mp_mask, torch.arange(m.max_mp, dtype=torch.int32,
                                                  device=m.device), -1)
        m = ms.erase_mappoints(m, slots)
    kf_mask = redundant_keyframes(m, protect_kf)
    kf_ids = torch.nonzero(kf_mask)[:max_kf_per_round, 0].tolist()
    for k in kf_ids:
        m = ms.erase_keyframe(m, int(k))
    return m, len(kf_ids), n_mp
