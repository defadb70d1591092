"""Full ORB extraction: pyramid -> FAST (kernel K1) -> per-cell top-k ->
per-level top-n -> orientation -> BRIEF, into a fixed-size FrameFeatures
batch (counterpart of multi_orbslam3_tpu/frontend/extractor.py).

Top-k selection uses a stable descending sort, so tied scores keep the
lower index first as ``jax.lax.top_k`` does (``torch.topk`` does not
promise an order among ties, and FAST scores on 8-bit images tie often).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from multi_orbslam3_tpu_torch.frontend import kernels, orb, pyramid
from multi_orbslam3_tpu_torch.geometry import camera as cam

EDGE_MARGIN = 19


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame feature batch (same fields as the JAX
    package's FrameFeatures; ``desc`` holds int32 bit patterns)."""

    uv: torch.Tensor        # (N, 2) raw pixel coords at level-0 scale
    uv_und: torch.Tensor    # (N, 2) undistorted pixel coords
    response: torch.Tensor  # (N,) FAST score
    level: torch.Tensor     # (N,) int32 pyramid level
    angle: torch.Tensor     # (N,) orientation (radians)
    desc: torch.Tensor      # (N, 8) int32 packed BRIEF-256
    valid: torch.Tensor     # (N,) bool padding mask

    @property
    def n(self) -> int:
        return self.uv.shape[0]


def level_feature_counts(n_features: int, n_levels: int,
                         scale_factor: float) -> Tuple[int, ...]:
    """Geometric per-level budget (reference ORBextractor.cc:427-439)."""
    q = 1.0 / scale_factor
    total = (1.0 - q ** n_levels) / (1.0 - q)
    counts = []
    acc = 0
    for lv in range(n_levels - 1):
        c = int(round(n_features * q ** lv / total))
        counts.append(c)
        acc += c
    counts.append(max(0, n_features - acc))
    return tuple(counts)


def topk_stable(x: torch.Tensor, k: int, dim: int = -1):
    """Top-k values and indices with ties broken by the lower index."""
    v, i = torch.sort(x, dim=dim, descending=True, stable=True)
    return v.narrow(dim, 0, k), i.narrow(dim, 0, k)


def select_level_keypoints(score: torch.Tensor, n_out: int, cell: int,
                           k_cell: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell top-k then global top-n over a score map. Returns
    (uv (n_out, 2) float32 at this level's scale, score (n_out,))."""
    h, w = score.shape
    padded = F.pad(score, (0, (-w) % cell, 0, (-h) % cell))
    hp, wp = padded.shape
    ncy, ncx = hp // cell, wp // cell
    cells = padded.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cell * cell)
    cv, ci = topk_stable(cells, k_cell, dim=1)
    cid = torch.arange(ncy * ncx, device=score.device)
    py = (cid // ncx)[:, None] * cell + ci // cell
    px = (cid % ncx)[:, None] * cell + ci % cell
    flat_v = cv.reshape(-1)
    flat_y = py.reshape(-1)
    flat_x = px.reshape(-1)
    if flat_v.shape[0] < n_out:
        # small levels can have fewer candidate slots than the budget:
        # pad with score-0 entries so every level emits exactly n_out rows
        pad = n_out - flat_v.shape[0]
        flat_v = F.pad(flat_v, (0, pad))
        flat_y = F.pad(flat_y, (0, pad))
        flat_x = F.pad(flat_x, (0, pad))
    top_v, top_i = topk_stable(flat_v, n_out)
    uv = torch.stack([flat_x[top_i].float(), flat_y[top_i].float()], dim=-1)
    return uv, top_v


@functools.lru_cache(maxsize=8)
def _camera_consts(cam_cfg, device: torch.device):
    K = cam.intrinsics_from_config(cam_cfg, device)
    vals = tuple(cam_cfg.kb) + (0.0,) if cam_cfg.model == "kb8" else tuple(cam_cfg.dist)
    return K, torch.tensor(vals, dtype=torch.float32, device=device)


def extract_features(img: torch.Tensor, config) -> FrameFeatures:
    """ORB features of one (H, W) grayscale image in [0, 255] (uint8 or
    float32, on the device the features should live on)."""
    o = config.orb
    c = config.camera
    img = img.float()
    fast_hi, fast_lo = o.fast_threshold, o.fast_threshold_min
    counts = level_feature_counts(o.n_features, o.n_levels, o.scale_factor)
    levels = pyramid.build_pyramid(img, o.n_levels, o.scale_factor)

    uvs, resps, lvls, angs, descs, valids = [], [], [], [], [], []
    strong_bonus = 1e6
    for lv, im in enumerate(levels):
        n_lv = counts[lv]
        if n_lv == 0:
            continue
        s = kernels.fast_score_nms(im, fast_lo)
        h, w = im.shape
        ys = torch.arange(h, device=im.device)[:, None]
        xs = torch.arange(w, device=im.device)[None, :]
        interior = ((ys >= EDGE_MARGIN) & (ys < h - EDGE_MARGIN)
                    & (xs >= EDGE_MARGIN) & (xs < w - EDGE_MARGIN))
        s = torch.where(interior, s, torch.zeros_like(s))
        eff = s + torch.where(s >= fast_hi, strong_bonus, 0.0)
        uv_lv, eff_v = select_level_keypoints(eff, n_lv, o.cell_size, 4)
        valid = eff_v > 0.0
        resp = torch.where(eff_v >= strong_bonus, eff_v - strong_bonus, eff_v)
        ang = orb.ic_angle(im, uv_lv)
        desc = orb.compute_descriptors(pyramid.gaussian_blur(im), uv_lv, ang)
        uvs.append(uv_lv * float(o.scale_factor ** lv))
        resps.append(resp)
        lvls.append(torch.full((n_lv,), lv, dtype=torch.int32, device=im.device))
        angs.append(ang)
        descs.append(desc)
        valids.append(valid)

    n = o.n_features
    uv = torch.cat(uvs)[:n]
    response = torch.cat(resps)[:n]
    level = torch.cat(lvls)[:n]
    angle = torch.cat(angs)[:n]
    desc = torch.cat(descs)[:n]
    valid = torch.cat(valids)[:n]
    padn = n - uv.shape[0]
    if padn > 0:
        uv = F.pad(uv, (0, 0, 0, padn))
        response = F.pad(response, (0, padn))
        level = F.pad(level, (0, padn))
        angle = F.pad(angle, (0, padn))
        desc = F.pad(desc, (0, 0, 0, padn))
        valid = F.pad(valid, (0, padn))

    K, dist = _camera_consts(c, img.device)
    if c.model == "kb8":
        # fisheye keypoints are re-projected onto the ideal pinhole K; the
        # far periphery (bearing z <= 0.3) is dropped
        bearing = cam.kb8_unproject(K, dist[:4], uv)
        bnorm = bearing / torch.linalg.norm(bearing, dim=-1, keepdim=True)
        valid = valid & (bnorm[..., 2] > 0.3)
        uv_und = cam.project(K, bearing)
    else:
        uv_und = cam.undistort_pixels(K, uv, dist)
    return FrameFeatures(uv=uv, uv_und=uv_und, response=response, level=level,
                         angle=angle, desc=desc.contiguous(), valid=valid)
