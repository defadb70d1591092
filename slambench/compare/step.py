"""The stereo system's fused step (capture kind "step"): each sampled
frame recomputed from its images and the map it was tracked against.

- feature_rows_differ: left-image feature rows (keypoint, level, validity,
  descriptor) that differ, over all rows of the sampled frames (K1 and the
  ORB descriptors);
- stereo_rows_differ: rows whose stereo match or depth (1e-4 relative)
  differs (the stereo match's depths);
- track_assoc_differ: features whose final landmark association differs,
  over the features associated on either side;
- pose_err_m: the largest distance between the port's and the reference's
  camera centre of a sampled frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference import frontend as rf
from slambench.reference import tracking as rt


def _rows_differ(a, b) -> torch.Tensor:
    """(N,) bool: rows of two feature batches that differ anywhere."""
    d = ~torch.all(a.desc == b.desc, dim=1)
    d |= ~torch.all(a.uv == b.uv, dim=1)
    d |= a.level.to(torch.int32) != b.level.to(torch.int32)
    return d | (a.valid != b.valid)


def _center(T: torch.Tensor) -> torch.Tensor:
    return -(T[:3, :3].T @ T[:3, 3])


class _Res(NamedTuple):
    pose: torch.Tensor
    feat_mp: torch.Tensor


def check(items, cfg, device, tally) -> None:
    bf = float(cfg.camera.baseline * cfg.camera.fx)
    for it in items:
        feats_p, sd_p, res_p, pose_p, _ = it["out"]
        fl, fr = rf.extract_pair(it["il"], it["ir"], cfg)
        sd = rf.stereo_match(fl, fr, bf)
        d = (sd.valid != sd_p.valid) | (sd.valid & (
            torch.abs(sd.depth - sd_p.depth) > 1e-4 * torch.abs(sd.depth)))
        tally.frac("stereo_rows_differ", d.sum(), d.numel())
        T_pred = it["T_vel"] @ it["T_cur"]
        tr = rt.track_frame(it["m"], fl, T_pred, cfg, u_r=sd.u_right, bf=bf)
        pose_r = rt.chained_pose(cfg, tr, T_pred)
        d = _rows_differ(feats_p, fl)
        tally.frac("feature_rows_differ", d.sum(), d.numel())
        a, b = res_p.feat_mp, tr.feat_mp
        either = (a >= 0) | (b >= 0)
        tally.frac("track_assoc_differ", (either & (a != b)).sum(), either.sum())
        tally.worst("pose_err_m", torch.linalg.norm(_center(pose_p) - _center(pose_r)))


def control(items, cfg, device) -> list:
    """The reference's step in TF32, its outputs shaped as the port's."""
    bf = float(cfg.camera.baseline * cfg.camera.fx)
    out = []
    for it in items:
        it = dict(it)
        fl, fr = rf.extract_pair(it["il"], it["ir"], cfg)
        sd = rf.stereo_match(fl, fr, bf)
        T_pred = it["T_vel"] @ it["T_cur"]
        tr = rt.track_frame(it["m"], fl, T_pred, cfg, u_r=sd.u_right, bf=bf)
        it["out"] = (fl, sd, _Res(tr.pose, tr.feat_mp),
                     rt.chained_pose(cfg, tr, T_pred), None)
        out.append(it)
    return out
