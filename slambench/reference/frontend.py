"""Plain frontend for the reference: the image pyramid, FAST-9/16 with 3x3
NMS, per-cell selection, intensity-centroid orientation, steered BRIEF-256,
the stereo match and the three Hamming best-two searches (validity,
projection, stereo), all as dense torch operations with no kernel. A frozen
copy of the port's plain versions (frontend/fast.py, pyramid.py, orb.py,
extractor.py, stereo.py and the *_ref functions of frontend/kernels.py as
of this benchmark's first commit). Imports nothing of the port."""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from slambench.reference import geometry as geo

BIG = 10_000
EDGE_MARGIN = 19
STEREO_MIN_DISPARITY = 0.3
STEREO_LEVEL_SLACK = 1
STEREO_TOL_LEVELS = 512
TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30


class Features(NamedTuple):
    uv: torch.Tensor
    uv_und: torch.Tensor
    response: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor


class Stereo(NamedTuple):
    u_right: torch.Tensor
    depth: torch.Tensor
    valid: torch.Tensor


# ---------------------------------------------------------------- FAST
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


# ---------------------------------------------------------------- pyramid
def level_shapes(height: int, width: int, n_levels: int,
                 scale_factor: float) -> List[Tuple[int, int]]:
    shapes = []
    for lv in range(n_levels):
        s = scale_factor ** lv
        shapes.append((max(16, int(round(height / s))),
                       max(16, int(round(width / s)))))
    return shapes


def _resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    return F.interpolate(img[None, None], size=out_hw, mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


def build_pyramid(img: torch.Tensor, n_levels: int,
                  scale_factor: float) -> List[torch.Tensor]:
    """(H, W) float32 image -> n_levels images, each resized from the
    previous one (cascaded, like the reference)."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    out = [img]
    cur = img
    for lv in range(1, n_levels):
        cur = _resize_bilinear(cur, shapes[lv])
        out.append(cur)
    return out


def _gauss_kernel(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0,
                  radius: int = 3) -> torch.Tensor:
    """Separable 7x7 Gaussian blur with edge padding (the reference blurs
    each level before BRIEF sampling)."""
    k = _gauss_kernel(sigma, radius, img.device)
    x = img[None, None]
    x = F.conv2d(F.pad(x, (radius, radius, 0, 0), mode="replicate"),
                 k.view(1, 1, 1, -1))
    x = F.conv2d(F.pad(x, (0, 0, radius, radius), mode="replicate"),
                 k.view(1, 1, -1, 1))
    return x[0, 0]


# ---------------------------------------------------------------- ORB
HALF_PATCH = 15
PATCH = 2 * HALF_PATCH + 1
N_BITS = 256
DESC_WORDS = 8
_PATTERN_SEED = 20260817


def brief_pattern() -> np.ndarray:
    """(256, 2, 2) int32: per bit, two (x, y) offsets in [-13, 13]; the
    same seeded Gaussian pattern as the JAX package's orb.brief_pattern."""
    rng = np.random.RandomState(_PATTERN_SEED)
    sigma = PATCH / 5.0
    pts = rng.randn(N_BITS, 2, 2) * sigma
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    max_r = 13.0
    scale = np.where(norm > max_r, max_r / (norm + 1e-9), 1.0)
    return np.round(pts * scale).astype(np.int32)


def circular_mask() -> np.ndarray:
    """(PATCH, PATCH) float32 mask of the orientation circle."""
    ys, xs = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    return ((xs * xs + ys * ys) <= HALF_PATCH * HALF_PATCH).astype(np.float32)


def _device_consts(device: torch.device):
    """Pattern, moment weights and bit shifts on `device`."""
    mask = torch.from_numpy(circular_mask()).to(device)
    coords = torch.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=torch.float32,
                          device=device)
    return {
        "pattern": torch.from_numpy(brief_pattern()).to(device, torch.float32),
        "w10": mask * coords[None, :],        # x-moment weights
        "w01": mask * coords[:, None],        # y-moment weights
        "shifts": torch.arange(32, dtype=torch.int64, device=device),
    }


def gather_patches(img: torch.Tensor, uv: torch.Tensor, half: int) -> torch.Tensor:
    """(H, W) image, (N, 2) keypoints -> (N, P, P) patches; corners are
    clamped into the image so padding slots read valid (masked) data."""
    h, w = img.shape
    size = 2 * half + 1
    y0 = torch.clamp(torch.round(uv[:, 1]).long() - half, 0, h - size)
    x0 = torch.clamp(torch.round(uv[:, 0]).long() - half, 0, w - size)
    offs = torch.arange(size, device=img.device)
    rows = y0[:, None] + offs[None, :]
    cols = x0[:, None] + offs[None, :]
    return img[rows[:, :, None], cols[:, None, :]]


def ic_angle(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation: (N, 2) -> (N,) radians."""
    c = _device_consts(img.device)
    patches = gather_patches(img, uv, HALF_PATCH)
    m10 = torch.sum(patches * c["w10"], dim=(1, 2))
    m01 = torch.sum(patches * c["w01"], dim=(1, 2))
    return torch.atan2(m01, m10)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 words; bit b of word k is bit
    32 k + b (the JAX package's uint32 layout, as int32 bit patterns)."""
    shifts = _device_consts(bits.device)["shifts"]
    words = torch.sum(bits.reshape(bits.shape[0], DESC_WORDS, 32).long()
                      << shifts, dim=-1)                 # [0, 2^32)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def compute_descriptors(img_blur: torch.Tensor, uv: torch.Tensor,
                        angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256: (N, 2) keypoints + (N,) angles -> (N, 8) int32.
    Nearest-neighbour sampling at the rotated pattern offsets."""
    h, w = img_blur.shape
    pat = _device_consts(img_blur.device)["pattern"]
    ca, sa = torch.cos(angle), torch.sin(angle)
    px = pat[None, :, :, 0]
    py = pat[None, :, :, 1]
    rx = ca[:, None, None] * px - sa[:, None, None] * py
    ry = sa[:, None, None] * px + ca[:, None, None] * py
    sx = torch.clamp(torch.round(uv[:, 0, None, None] + rx), 0, w - 1).long()
    sy = torch.clamp(torch.round(uv[:, 1, None, None] + ry), 0, h - 1).long()
    vals = img_blur[sy, sx]                               # (N, 256, 2)
    return pack_bits(vals[..., 0] < vals[..., 1])


# ---------------------------------------------------------------- extraction
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


def extract_pair(img_l: torch.Tensor, img_r: torch.Tensor, config) -> Tuple[Features, Features]:
    """ORB features of both images of a stereo frame (uint8 or float32)."""
    return extract(img_l, config), extract(img_r, config)


def extract(img: torch.Tensor, config) -> Features:
    """ORB features of one (H, W) grayscale image in [0, 255]."""
    o = config.orb
    levels = build_pyramid(img.float(), o.n_levels, o.scale_factor)
    scores = [nms3x3(fast_score(im.contiguous(), o.fast_threshold_min)) for im in levels]
    return _features_from_scores(levels, scores, config)


def _features_from_scores(levels, scores, config) -> FrameFeatures:
    """Everything after K1: per-level selection, orientation, BRIEF, the
    fixed-size batch and undistortion."""
    o = config.orb
    c = config.camera
    fast_hi = o.fast_threshold
    counts = level_feature_counts(o.n_features, o.n_levels, o.scale_factor)

    uvs, resps, lvls, angs, descs, valids = [], [], [], [], [], []
    strong_bonus = 1e6
    for lv, im in enumerate(levels):
        n_lv = counts[lv]
        if n_lv == 0:
            continue
        s = scores[lv]
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
        ang = ic_angle(im, uv_lv)
        desc = compute_descriptors(gaussian_blur(im), uv_lv, ang)
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

    if c.model != "pinhole":
        raise ValueError("the reference frontend models the pinhole camera only")
    K = geo.intrinsics_from_config(c, uv.device)
    dist = torch.tensor(tuple(c.dist), dtype=torch.float32, device=uv.device)
    uv_und = geo.undistort_pixels(K, uv, dist)
    return Features(uv=uv, uv_und=uv_und, response=response, level=level,
                    angle=angle, desc=desc.contiguous(), valid=valid)


# ---------------------------------------------------------------- K2
def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v & 0xFF) + ((v >> 8) & 0xFF) + ((v >> 16) & 0xFF) + ((v >> 24) & 0xFF)


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) int32 words -> (N, M) int32 Hamming distances."""
    acc = torch.zeros((d1.shape[0], d2.shape[0]), dtype=torch.int32, device=d1.device)
    for wd in range(d1.shape[1]):
        acc += popcount32(d1[:, None, wd] ^ d2[None, :, wd])
    return acc


def best_two(dist: torch.Tensor):
    """Per-row best index (first on ties), best and second-best distance."""
    best_idx = torch.argmin(dist, dim=1)
    best = torch.gather(dist, 1, best_idx[:, None])[:, 0]
    masked = dist.scatter(1, best_idx[:, None], BIG)
    return best_idx, best, torch.amin(masked, dim=1)


def best_two_valid(d1, valid1, d2, valid2, row_block: int = 4096):
    """The validity-masked search: (idx, best, second) a row, the first
    row of each column's minimum and that minimum, in blocks of rows."""
    n = d1.shape[0]
    rows, col_min, col_arg = [], None, None
    for r0 in range(0, max(n, 1), row_block):
        dist = torch.where(valid1[r0:r0 + row_block, None] & valid2[None, :],
                           hamming_matrix(d1[r0:r0 + row_block], d2), BIG)
        rows.append(best_two(dist))
        cmin = torch.amin(dist, dim=0)
        carg = torch.argmin(dist, dim=0) + r0
        if col_min is None:
            col_min, col_arg = cmin, carg
        else:
            col_arg = torch.where(cmin < col_min, carg, col_arg)
            col_min = torch.minimum(cmin, col_min)
    idx, best, second = (torch.cat(parts) for parts in zip(*rows))
    return idx, best, second, col_arg, col_min


def best_two_projection(mp_desc, proj_uv, proj_valid, radius, pred_level, feat_desc,
                        feat_uv, feat_valid, feat_level, level_slack: int,
                        row_block: int = 4096):
    """The projection-masked search: radius, level window and validity."""
    n = proj_uv.shape[0]
    r = (radius.expand(n) if isinstance(radius, torch.Tensor)
         else torch.full((n,), float(radius), device=proj_uv.device))
    out = []
    for r0 in range(0, max(n, 1), row_block):
        sl = slice(r0, r0 + row_block)
        d2 = torch.sum((proj_uv[sl, None, :] - feat_uv[None, :, :]) ** 2, dim=-1)
        mask = ((d2 <= (r[sl, None] ** 2))
                & (torch.abs(feat_level[None, :] - pred_level[sl, None]) <= level_slack)
                & proj_valid[sl, None] & feat_valid[None, :])
        out.append(best_two(torch.where(mask, hamming_matrix(mp_desc[sl], feat_desc), BIG)))
    return tuple(torch.cat(parts) for parts in zip(*out))


def stereo_row_tolerance(level: torch.Tensor, row_tol: float) -> torch.Tensor:
    """row_tol * 1.2^level in float32 (the power in float64 on float32(1.2))."""
    with np.errstate(over="ignore"):
        table = np.float32(row_tol) * (np.float64(np.float32(1.2))
                                       ** np.arange(STEREO_TOL_LEVELS)).astype(np.float32)
    table = torch.from_numpy(table).to(level.device)
    return table[torch.clamp(level, 0, STEREO_TOL_LEVELS - 1).long()]


def best_two_stereo(descL, uvL, validL, levelL, tol, descR, uvR, validR, levelR,
                    max_disparity: float):
    """The stereo-masked search: epipolar row, disparity and level window."""
    f32 = dict(dtype=torch.float32, device=uvL.device)
    dv = torch.abs(uvL[:, None, 1] - uvR[None, :, 1])
    disp = uvL[:, None, 0] - uvR[None, :, 0]
    lv_ok = torch.abs(levelL[:, None] - levelR[None, :]) <= STEREO_LEVEL_SLACK
    mask = ((dv <= tol[:, None])
            & (disp > torch.tensor(STEREO_MIN_DISPARITY, **f32))
            & (disp < torch.tensor(max_disparity, **f32))
            & lv_ok & validL[:, None] & validR[None, :])
    return best_two(torch.where(mask, hamming_matrix(descL, descR), BIG))


def stereo_match(fl: Features, fr: Features, baseline_fx, row_tol: float = 2.0,
                 max_disparity: float = 128.0, max_dist: int = TH_HIGH) -> Stereo:
    """Rectified left/right features matched along epipolar rows; depth =
    baseline_fx / disparity."""
    levelL = fl.level.to(torch.int32)
    uvL, uvR = fl.uv_und, fr.uv_und
    idx, best, second = best_two_stereo(
        fl.desc, uvL, fl.valid, levelL, stereo_row_tolerance(levelL, row_tol),
        fr.desc, uvR, fr.valid, fr.level.to(torch.int32), max_disparity)
    ok = (best <= max_dist) & ((best <= 0.9 * second) | (second >= BIG))
    u_r = uvR[torch.where(ok, idx, 0), 0]
    d = uvL[:, 0] - u_r
    depth = baseline_fx / torch.clamp(d, min=1e-6)
    return Stereo(u_right=torch.where(ok, u_r, -1.0),
                  depth=torch.where(ok, depth, -1.0), valid=ok)
