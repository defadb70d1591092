"""The comparison that decides `correct`: the plain reference
(slambench/reference) works out again, from the inputs the benchmark handed
the port and the map the port held, what each sampled call of the window
produced, and each compared number is held to its limit in
slambench/checks/<cell>.json.

The reference follows the port step by step from the port's own state: a
tracked frame is recomputed from the frame's images and the map that frame
was tracked against; a place-recognition query from the query keyframe's
descriptors and every database keyframe's descriptors in the map; a K2
search from its inputs. The numbers:

- feature_rows_differ: left-image feature rows (keypoint, level, validity,
  descriptor) that differ, over all rows of the sampled frames (K1 and the
  ORB descriptors);
- stereo_rows_differ: rows whose stereo match or depth (1e-4 relative)
  differs (the stereo match's depths);
- k2_rows_differ: rows (and columns, for the validity search) of the
  sampled K2 calls of tracking, mapping and loop closing whose best index,
  best or second distance differs;
- track_assoc_differ: features whose final landmark association differs,
  over the features associated on either side;
- pose_err_m: the largest distance between the port's and the reference's
  camera centre of a sampled frame;
- bow_score_err: the largest score difference of a sampled query over the
  largest reference score of that query.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from slambench.reference import bow as rbow
from slambench.reference import float32_precision
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


class Tally:
    def __init__(self):
        self.num, self.den, self.max = {}, {}, {}

    def frac(self, name: str, bad, total) -> None:
        self.num[name] = self.num.get(name, 0) + int(bad)
        self.den[name] = self.den.get(name, 0) + int(total)

    def worst(self, name: str, value: float) -> None:
        self.max[name] = max(self.max.get(name, 0.0), float(value))

    def numbers(self) -> dict:
        out = {k: self.num[k] / max(self.den[k], 1) for k in self.num}
        out.update(self.max)
        return out


def check_steps(items, cfg, tally: Tally) -> None:
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


def check_k2(items, tally: Tally) -> None:
    for it in items:
        if len(it["args"]) == 4:
            d1, v1, d2, v2 = it["args"]
            idx, best, second, col_arg, col_min = rf.best_two_valid(d1, v1, d2, v2)
            p_idx, p_best, p_second, p_col = it["out"]
            bad_c = (col_min < rf.BIG) & (p_col.to(col_arg.dtype) != col_arg)
            tally.frac("k2_rows_differ", bad_c.sum(), bad_c.numel())
        else:
            idx, best, second = rf.best_two_projection(*it["args"])
            p_idx, p_best, p_second = it["out"]
        bad = (p_best != best) | (p_second != second) | (
            (best < rf.BIG) & (p_idx.to(idx.dtype) != idx))
        tally.frac("k2_rows_differ", bad.sum(), bad.numel())


def check_bow(items, cfg, device, tally: Tally) -> None:
    """Every active row of a sampled query: the reference's cosine score,
    0 where the port's exclusion mask (its covisible group) drops the row."""
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


class _Res(NamedTuple):
    pose: torch.Tensor
    feat_mp: torch.Tensor


def control_items(capture, cfg, device) -> dict:
    """The control: the reference in TF32 put in the port's place, its
    outputs shaped as the port's (the comparison then runs as for a run)."""
    bf = float(cfg.camera.baseline * cfg.camera.fx)
    out = {"step": [], "bow": [], "k2": capture.items("k2proj") + capture.items("k2valid")}
    with torch.no_grad(), float32_precision(tf32=True):
        for it in capture.items("step"):
            it = dict(it)
            fl, fr = rf.extract_pair(it["il"], it["ir"], cfg)
            sd = rf.stereo_match(fl, fr, bf)
            T_pred = it["T_vel"] @ it["T_cur"]
            tr = rt.track_frame(it["m"], fl, T_pred, cfg, u_r=sd.u_right, bf=bf)
            it["out"] = (fl, sd, _Res(tr.pose, tr.feat_mp),
                         rt.chained_pose(cfg, tr, T_pred), None)
            out["step"].append(it)
        items = capture.items("bow")
        if items:
            voc = rbow.Vocabulary(cfg.bow.branching, cfg.bow.levels, device)
            for it in items:
                it = dict(it)
                rows = torch.arange(it["active"].shape[0], device=it["active"].device)
                s = rbow.scores(voc, it["desc"], it["valid"], it["m"].kf_desc,
                                it["m"].kf_feat_valid, rows)
                it["scores"] = torch.where(it["active"] & ~it["exclude"], s, 0.0)
                out["bow"].append(it)
    return out


def run_checks(capture, cfg, device, control: bool = False) -> dict:
    """Every compared number of the captured calls against the reference
    in float32; with control=True, of the control's outputs instead."""
    items = (control_items(capture, cfg, device) if control else
             {"step": capture.items("step"), "bow": capture.items("bow"),
              "k2": capture.items("k2proj") + capture.items("k2valid")})
    tally = Tally()
    with torch.no_grad(), float32_precision(False):
        check_steps(items["step"], cfg, tally)
        check_k2(items["k2"], tally)
        check_bow(items["bow"], cfg, device, tally)
    return tally.numbers()


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number of the cell's check
    file finite and within its limit. A number marked "every_run" must be
    there; the others (place recognition) only where the window made such
    a call."""
    rows, ok = [], True
    for name, spec in limits.items():
        v = numbers.get(name)
        lim = float(spec["limit"])
        good = (v is None and not spec.get("every_run", True)) or (
            v is not None and math.isfinite(v) and v <= lim)
        ok &= good
        rows.append((name, v, lim))
    return ok, rows
