"""Headless map visualization (counterpart of multi_orbslam3_tpu/eval/viewer.py).

The reference draws with Pangolin (ClientViewer/ServerViewer/MapDrawer/
FrameDrawer); the JAX package renders with matplotlib, which the GPU
machine does not have. The port rasterises with numpy and writes the
image with PIL's PNG encoder (the one dataio/mini_asl.py writes frames
with):

- ``plot_map``: a top-down (x-z) view of the map on a white canvas,
  landmarks as grey dots, each agent's keyframe centres as a coloured
  polyline with dots (the JAX package's colours), the ground-truth
  centres as a dashed black line; the title goes into the PNG's ``Title``
  text chunk (the raster has no fonts, so no legend either);
- ``plot_frame``: the frame in grey with a ring at every keypoint, green
  where a landmark is tracked and blue elsewhere.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multi_orbslam3_tpu_torch.map.mapstate import MapState

# matplotlib's tab:blue, tab:orange, tab:green, tab:red
_AGENT_COLORS = np.array([[31, 119, 180], [255, 127, 14], [44, 160, 44],
                          [214, 39, 40]], np.uint8)
_LANDMARK = np.array([150, 150, 150], np.uint8)
_BLACK = np.array([0, 0, 0], np.uint8)
_LIME = np.array([0, 255, 0], np.uint8)
_MAP_PX = 800           # side of the map image


def _save(path: str, rgb: np.ndarray, title: Optional[str] = None) -> None:
    from PIL import Image, PngImagePlugin
    info = PngImagePlugin.PngInfo()
    if title is not None:
        info.add_text("Title", title)
    Image.fromarray(rgb).save(path, format="PNG", pnginfo=info)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _put(img: np.ndarray, rc: np.ndarray, color: np.ndarray) -> None:
    """Colour the pixels (row, col) of rc that lie inside img."""
    rc = rc.reshape(-1, 2)
    ok = ((rc >= 0) & (rc < np.array(img.shape[:2]))).all(1)
    img[rc[ok, 0], rc[ok, 1]] = color


def _dots(img: np.ndarray, rc: np.ndarray, color: np.ndarray, radius: int = 0) -> None:
    for dr in range(-radius, radius + 1):
        for dc in range(-radius, radius + 1):
            _put(img, rc + np.array([dr, dc]), color)


def _polyline(img: np.ndarray, rc: np.ndarray, color: np.ndarray, dash: int = 0) -> None:
    """Segments between consecutive points; dash > 0 draws dash pixels of
    every 2 x dash along each segment."""
    for a, b in zip(rc[:-1], rc[1:]):
        n = int(np.abs(b - a).max()) + 1
        seg = np.round(a + (b - a) * np.linspace(0.0, 1.0, n)[:, None]).astype(np.int64)
        _put(img, seg[(np.arange(n) // dash) % 2 == 0] if dash else seg, color)


def _rings(img: np.ndarray, rc: np.ndarray, color: np.ndarray, radius: int = 3) -> None:
    ang = np.linspace(0.0, 2 * np.pi, 8 * radius, endpoint=False)
    ring = np.round(np.stack([np.sin(ang), np.cos(ang)], 1) * radius).astype(np.int64)
    for off in np.unique(ring, axis=0):
        _put(img, rc + off, color)


def _top_down(pts_xz: np.ndarray, size: int = _MAP_PX, margin: int = 24):
    """The map of world (x, z) to pixels (row, col) of a size x size canvas
    that fits pts_xz: x to the right, z up, one scale."""
    lo = pts_xz.min(0) if len(pts_xz) else np.zeros(2)
    hi = pts_xz.max(0) if len(pts_xz) else np.ones(2)
    center = (lo + hi) / 2.0
    scale = (size - 2 * margin) / max(float((hi - lo).max()), 1e-6)

    def to_px(xz: np.ndarray) -> np.ndarray:
        d = (np.asarray(xz, np.float64) - center) * scale
        return np.stack([np.round(size / 2.0 - d[:, 1]), np.round(size / 2.0 + d[:, 0])],
                        1).astype(np.int64)
    return to_px


def plot_map(m: MapState, path: str, title: str = "map",
             gt_centers: Optional[np.ndarray] = None) -> None:
    """Top-down (x-z) map snapshot (MapDrawer::DrawMapPoints/DrawKeyFrames
    analog), keyframes coloured by agent."""
    mp_valid = _host(m.mp_valid).astype(bool)
    mp = _host(m.mp_pos)[mp_valid]
    kf_valid = _host(m.kf_valid).astype(bool)
    poses = _host(m.kf_pose)[kf_valid]
    agents = _host(m.kf_agent)[kf_valid]
    centers = -np.einsum("nji,nj->ni", poses[:, :3, :3], poses[:, :3, 3]) \
        if len(poses) else np.zeros((0, 3))
    gt = np.zeros((0, 3)) if gt_centers is None else np.asarray(gt_centers)
    img = np.full((_MAP_PX, _MAP_PX, 3), 255, np.uint8)
    to_px = _top_down(np.concatenate([mp, centers, gt])[:, [0, 2]])
    if len(mp):
        _dots(img, to_px(mp[:, [0, 2]]), _LANDMARK)
    for a in np.unique(agents):
        rc = to_px(centers[agents == a][:, [0, 2]])
        color = _AGENT_COLORS[int(a) % len(_AGENT_COLORS)]
        _polyline(img, rc, color)
        _dots(img, rc, color, radius=2)
    if len(gt):
        _polyline(img, to_px(gt[:, [0, 2]]), _BLACK, dash=6)
    _save(path, img, title)


def plot_frame(img: np.ndarray, uv: np.ndarray, tracked: np.ndarray,
               path: str) -> None:
    """Keypoint overlay (FrameDrawer analog): green = tracked landmark,
    blue = unmatched keypoint."""
    grey = np.clip(np.round(_host(img)), 0, 255).astype(np.uint8)
    img = np.repeat(grey[:, :, None], 3, axis=2)
    rc = np.round(_host(uv)[:, ::-1]).astype(np.int64)
    t = _host(tracked).astype(bool)
    _rings(img, rc[~t], _AGENT_COLORS[0])
    _rings(img, rc[t], _LIME)
    _save(path, img)
