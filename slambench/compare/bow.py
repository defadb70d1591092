"""Place recognition's BoW queries (capture kind "bow"): every active row
of a sampled query recomputed from the query keyframe's descriptors and
every database keyframe's descriptors in the map.

- bow_score_err: the largest score difference of a sampled query over the
  largest reference score of that query.
"""

from __future__ import annotations

import torch

from slambench.reference import bow as rbow


def check(items, cfg, device, tally) -> None:
    """The reference's cosine score, 0 where the port's exclusion mask (its
    covisible group) drops the row."""
    if not items:
        return
    voc = rbow.Vocabulary(cfg.bow.branching, cfg.bow.levels, device)
    for it in items:
        rows = torch.nonzero(it["active"])[:, 0]
        if rows.numel() == 0:
            continue
        m = it["m"]
        s = rbow.scores(voc, it["desc"], it["valid"], m.kf_desc, m.kf_feat_valid, rows)
        s = torch.where(it["exclude"][rows], 0.0, s)
        err = torch.max(torch.abs(s - it["scores"][rows]))
        tally.worst("bow_score_err", err / torch.clamp(torch.max(s), min=1e-6))


def control(items, cfg, device) -> list:
    """The reference's scores in TF32 over every row, 0 where inactive or
    excluded."""
    if not items:
        return []
    voc = rbow.Vocabulary(cfg.bow.branching, cfg.bow.levels, device)
    out = []
    for it in items:
        it = dict(it)
        rows = torch.arange(it["active"].shape[0], device=it["active"].device)
        s = rbow.scores(voc, it["desc"], it["valid"], it["m"].kf_desc,
                        it["m"].kf_feat_valid, rows)
        it["scores"] = torch.where(it["active"] & ~it["exclude"], s, 0.0)
        out.append(it)
    return out
