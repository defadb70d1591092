"""Stereo feature matching + RGB-D depth ingestion (counterpart of
multi_orbslam3_tpu/frontend/stereo.py).

``stereo_match`` is one masked Hamming match between the left and right
feature batches of a rectified pair: epipolar row proximity, a disparity
range and a pyramid-level window. It goes through kernel K2's fused stereo
form (``kernels.hamming_best_two_stereo``), so no N x M tensor is made on a
GPU; the acceptance test, the gathers and the depth are torch ops here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_orbslam3_tpu_torch.frontend import kernels, matcher
from multi_orbslam3_tpu_torch.frontend.extractor import FrameFeatures


class StereoDepth(NamedTuple):
    """Per-left-feature stereo measurements."""
    u_right: torch.Tensor   # (N,) right-image u coordinate (-1 no match)
    depth: torch.Tensor     # (N,) metric depth (-1 no match)
    valid: torch.Tensor     # (N,) bool


def stereo_match(featsL: FrameFeatures, featsR: FrameFeatures,
                 baseline_fx, row_tol: float = 2.0,
                 max_disparity: float = 128.0,
                 max_dist: int = matcher.TH_HIGH) -> StereoDepth:
    """Match rectified left/right feature batches along epipolar rows.
    baseline_fx = baseline * fx (so depth = baseline_fx / disparity). The
    row tolerance grows with the left feature's pyramid level."""
    levelL = featsL.level.to(torch.int32).contiguous()
    uvL = featsL.uv_und.contiguous()
    uvR = featsR.uv_und.contiguous()
    idx, best, second = kernels.hamming_best_two_stereo(
        featsL.desc.contiguous(), uvL, featsL.valid.contiguous(), levelL,
        kernels.stereo_row_tolerance(levelL, row_tol),
        featsR.desc.contiguous(), uvR, featsR.valid.contiguous(),
        featsR.level.to(torch.int32).contiguous(), max_disparity)
    # int32 * float stays float32, as in the JAX package
    ok = (best <= max_dist) & ((best <= 0.9 * second) | (second >= matcher.BIG))
    u_r = uvR[torch.where(ok, idx, 0), 0]
    d = uvL[:, 0] - u_r
    depth = baseline_fx / torch.clamp(d, min=1e-6)
    return StereoDepth(u_right=torch.where(ok, u_r, -1.0),
                       depth=torch.where(ok, depth, -1.0), valid=ok)


def rgbd_depth(feats: FrameFeatures, depth_img: torch.Tensor,
               baseline_fx) -> StereoDepth:
    """Depth-image lookup at the keypoint positions (rounded half to even);
    the virtual right coordinate is u_r = u - baseline_fx / depth."""
    h, w = depth_img.shape
    x = torch.clamp(torch.round(feats.uv[:, 0]).long(), 0, w - 1)
    y = torch.clamp(torch.round(feats.uv[:, 1]).long(), 0, h - 1)
    d = depth_img[y, x]
    ok = feats.valid & (d > 0.05)
    u_r = feats.uv_und[:, 0] - baseline_fx / torch.clamp(d, min=1e-6)
    return StereoDepth(u_right=torch.where(ok, u_r, -1.0),
                       depth=torch.where(ok, d, -1.0), valid=ok)
