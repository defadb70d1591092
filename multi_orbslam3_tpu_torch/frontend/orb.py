"""Oriented BRIEF-256 descriptors + intensity-centroid orientation
(counterpart of multi_orbslam3_tpu/frontend/orb.py).

Descriptors are (N, 8) int32: the bit patterns of the JAX package's uint32
words (torch has no popcount and few uint32 ops).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

HALF_PATCH = 15
PATCH = 2 * HALF_PATCH + 1
N_BITS = 256
DESC_WORDS = 8
_PATTERN_SEED = 20260817


@functools.lru_cache(maxsize=1)
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


@functools.lru_cache(maxsize=1)
def circular_mask() -> np.ndarray:
    """(PATCH, PATCH) float32 mask of the orientation circle."""
    ys, xs = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    return ((xs * xs + ys * ys) <= HALF_PATCH * HALF_PATCH).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _device_consts(device: torch.device):
    """Pattern, moment weights and bit shifts resident on `device` (made
    once: a host->device copy per frame would stall the stream)."""
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
