"""The traffic generator of a traffic file that names none: a
textured-landmark world drawn from the seed on the device, each agent's
trajectory from the traffic file, and every frame rendered on the device.
A traffic file that names a "generator" is made by
``generators/<generator>.py`` instead (slambench/generators/__init__.py).

The world and the renderer are a PyTorch copy of the port's
``dataio/synthetic.py`` (make_world, circular_pose_at, render_frame):
landmarks in a slab, each with a 9x9 texture patch carrying a strong corner,
splatted at its projected pixel with the nearest landmark on top. The seed
draws the landmarks, their patches and the sensor noise; the trajectories,
the agents' phases and the sequence length belong to the traffic file, so
every seed gives the same motion and the same number of frames.
slambench/tests/test_slambench_render.py holds the renderer to the NumPy
one, noise off, pixel for pixel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from slambench.harness import files

PATCH = 9


@dataclasses.dataclass
class AgentFrames:
    left: torch.Tensor                  # (F, H, W) uint8 on the device
    right: Optional[torch.Tensor]       # (F, H, W) uint8, stereo only
    T_cw: np.ndarray                    # (F, 4, 4) ground-truth poses
    timestamps: np.ndarray              # (F,) seconds


def _look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """(F, 3) eyes -> (F, 4, 4) camera-from-world poses, +z forward."""
    fwd = target[None, :] - eye
    fwd /= np.linalg.norm(fwd, axis=1, keepdims=True)
    right = np.cross(fwd, up[None, :])
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=2)
    T = np.tile(np.eye(4), (eye.shape[0], 1, 1))
    T[:, :3, :3] = np.transpose(R_wc, (0, 2, 1))
    T[:, :3, 3] = -np.einsum("fji,fj->fi", R_wc, eye)
    return T


def orbit_poses(n: int, phase: float, arc_rate: float, radius: float,
                height: float, center_dist: float) -> np.ndarray:
    """synthetic.circular_pose_at for frames 0 .. n - 1."""
    return orbit_poses_at(phase + arc_rate * np.arange(n, dtype=np.float64), radius,
                          height, center_dist)


def swing_angles(n: int, phase: float, amplitude: float, period: float) -> np.ndarray:
    """Orbit angles that swing back and forth over [phase, phase + 2 A]:
    a = phase + A (1 - cos(2 pi i / period)), so every `period` frames the
    agent re-flies the same arc, out and back."""
    i = np.arange(n, dtype=np.float64)
    return phase + amplitude * (1.0 - np.cos(2.0 * np.pi * i / period))


def orbit_poses_at(a: np.ndarray, radius: float, height: float,
                   center_dist: float) -> np.ndarray:
    """synthetic.circular_pose_at's pose at each orbit angle of `a`."""
    eye = np.stack([radius * np.sin(a), height + 0.2 * np.sin(3 * a),
                    radius * np.cos(a) - center_dist], axis=1)
    return _look_at(eye, np.array([0.0, 0.0, center_dist * 0.5]),
                    np.array([0.0, -1.0, 0.0]))


def make_world(n_points: int, gen: torch.Generator, device, extent: float = 6.0,
               depth_center: float = 4.0, depth_spread: float = 3.0):
    """(P, 3) float64 landmarks and (P, 9, 9) float32 patches from `gen`."""
    u = torch.rand((n_points, 3), generator=gen, dtype=torch.float64, device=device)
    lo = torch.tensor([-extent, -extent * 0.6, depth_center - depth_spread],
                      dtype=torch.float64, device=device)
    hi = torch.tensor([extent, extent * 0.6, depth_center + depth_spread],
                      dtype=torch.float64, device=device)
    pts = lo + u * (hi - lo)
    patches = 40.0 + 215.0 * torch.rand((n_points, PATCH, PATCH), generator=gen,
                                        dtype=torch.float32, device=device)
    patches[:, :PATCH // 2, :PATCH // 2] *= 0.15
    return pts, patches


def render(points: torch.Tensor, patches: torch.Tensor, T_cw: torch.Tensor,
           K: tuple, width: int, height: int, background: float = 12.0) -> torch.Tensor:
    """(F, H, W) float32 frames without noise: every visible landmark's
    patch at its rounded pixel, the nearest on top (synthetic.render_frame's
    painter's order, as a per-pixel minimum of the depth rank)."""
    fx, fy, cx, cy = K
    dev = points.device
    F_, P = T_cw.shape[0], points.shape[0]
    half = PATCH // 2
    pc = torch.einsum("fij,pj->fpi", T_cw[:, :3, :3], points) + T_cw[:, None, :3, 3]
    z = pc[..., 2]
    zc = torch.clamp(z, min=1e-6)
    u = fx * pc[..., 0] / zc + cx
    v = fy * pc[..., 1] / zc + cy
    vis = ((z > 0.3) & (u > half + 1) & (u < width - half - 2)
           & (v > half + 1) & (v < height - half - 2))
    ui = torch.round(torch.where(vis, u, 0.0)).long()
    vi = torch.round(torch.where(vis, v, 0.0)).long()
    order = torch.argsort(z, dim=1, stable=True)          # nearest first
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(P, device=dev).expand(F_, P).contiguous())
    off = torch.arange(-half, half + 1, device=dev)
    py = vi[..., None, None] + off[:, None]               # (F, P, 9, 1)
    px = ui[..., None, None] + off[None, :]               # (F, P, 1, 9)
    hw = height * width
    frame_base = (torch.arange(F_, device=dev) * hw)[:, None, None, None]
    pix = frame_base + py * width + px                    # (F, P, 9, 9)
    pix = torch.where(vis[..., None, None], pix, F_ * hw)  # spare slot
    key = torch.full((F_ * hw + 1,), P, dtype=torch.int64, device=dev)
    key.scatter_reduce_(0, pix.reshape(-1),
                        rank[..., None, None].expand_as(pix).reshape(-1), "amin")
    key = key[:-1].view(F_, hw)
    hit = key < P
    lm = torch.gather(order, 1, torch.where(hit, key, 0))  # (F, H*W) landmark
    ys = torch.arange(height, device=dev).repeat_interleave(width)
    xs = torch.arange(width, device=dev).repeat(height)
    oy = ys[None, :] - torch.gather(vi, 1, lm) + half
    ox = xs[None, :] - torch.gather(ui, 1, lm) + half
    oy = torch.where(hit, oy, 0)
    ox = torch.where(hit, ox, 0)
    vals = patches[lm, oy, ox]
    img = torch.where(hit, vals, torch.tensor(background, dtype=torch.float32, device=dev))
    return img.view(F_, height, width)


def _frames(points, patches, T_cw: np.ndarray, K, width, height, noise_std,
            gen, device, chunk: int) -> torch.Tensor:
    out = torch.empty((T_cw.shape[0], height, width), dtype=torch.uint8, device=device)
    T = torch.from_numpy(T_cw).to(device)
    for f0 in range(0, T_cw.shape[0], chunk):
        img = render(points, patches, T[f0:f0 + chunk], K, width, height)
        if noise_std > 0:
            img = img + noise_std * torch.randn(img.shape, generator=gen,
                                                dtype=torch.float32, device=device)
        # what the port's loop makes of a float frame (MonoSlam.to_device)
        out[f0:f0 + chunk] = torch.clamp(torch.round(img), 0.0, 255.0).to(torch.uint8)
    return out


def generate(traffic: dict, camera, seed: int, device, chunk: int = 16,
             where: tuple = (files.ROOT,)) -> list:
    """Every agent's frames of a traffic file, made on `device`: by the
    file's "generator" (`generators/<name>.py` under the cell's roots
    `where`), else rendered here as AgentFrames. camera: the port's
    CameraConfig (size, intrinsics, baseline)."""
    if "generator" in traffic:
        return files.load("generators", traffic["generator"], where).generate(
            traffic, camera, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    w = traffic.get("world", {})
    points, patches = make_world(int(traffic["landmarks"]), gen, device,
                                 extent=w.get("extent", 6.0),
                                 depth_center=w.get("depth_center", 4.0),
                                 depth_spread=w.get("depth_spread", 3.0))
    K = (camera.fx, camera.fy, camera.cx, camera.cy)
    n = int(traffic["frames_per_agent"])
    o = traffic["orbit"]
    ts = np.arange(n, dtype=np.float64) / float(traffic["fps"])
    agents = []
    for phase in traffic["phases_rad"]:
        if "swing_amplitude_rad" in o:
            a = swing_angles(n, float(phase), float(o["swing_amplitude_rad"]),
                             float(o["swing_period_frames"]))
        else:
            a = float(phase) + float(o["arc_rate_rad"]) * np.arange(n, dtype=np.float64)
        T_cw = orbit_poses_at(a, float(o["radius_m"]), float(o.get("height_m", 0.0)),
                              float(o["center_dist_m"]))
        left = _frames(points, patches, T_cw, K, camera.width, camera.height,
                       float(traffic["noise_std"]), gen, device, chunk)
        right = None
        if camera.baseline > 0:
            shift = np.eye(4)
            shift[0, 3] = -camera.baseline
            right = _frames(points, patches, shift[None] @ T_cw, K, camera.width,
                            camera.height, float(traffic["noise_std"]), gen, device, chunk)
        agents.append(AgentFrames(left=left, right=right, T_cw=T_cw.astype(np.float32),
                                  timestamps=ts))
    return agents
