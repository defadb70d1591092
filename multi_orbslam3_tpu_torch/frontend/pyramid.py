"""Image pyramid with fixed per-level shapes (counterpart of
multi_orbslam3_tpu/frontend/pyramid.py).

``jax.image.resize(..., "bilinear")`` antialiases when it downscales, so
the port resizes with ``F.interpolate(..., antialias=True)``. The two
frameworks build their filter weights differently: level 0 is identical,
levels >= 1 agree to a few 1e-3 grey levels, not bit for bit.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F


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


@functools.lru_cache(maxsize=8)
def _gauss_kernel(sigma: float, radius: int, device: torch.device) -> torch.Tensor:
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
