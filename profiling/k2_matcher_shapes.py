"""The shapes the main path gives K2's two fused matchers, per call site.

    python profiling/k2_matcher_shapes.py [--out DIR] [--no-collab]

On a CUDA card: one pass of bench_mono (chip_smoke.py's `slice` path, loop
closing on, 120 frames) and one deterministic pass of bench_collab
(chip_smoke.py's `collab` phase), with K2Recorder around
kernels.hamming_best_two_projection and kernels.hamming_best_two_valid.
Per call site (the pipeline function that called the matcher, with n and
m) it prints one JSON line: calls, valid rows, valid columns, and for the
projection match the radius range, the level slack, the pairs inside the
window (radius and level, both valid) and the columns a grid-indexed
search visits at cells of 8, 16 and 32 px (the valid columns whose cell
lies within one spare cell of the row's square u +- r, v +- r, summed over
the valid rows; per row p50 / p90 / max at 16 px). The full records go to
DIR/k2_shapes.json and the captured inputs (the 60th coarse tracking call
and the first keyframe-pair triangulation after it) to
DIR/k2_cases.pt. The recorder reads counts back from the device after every
call, so the passes run slower than chip_smoke.py's; the matchers' results
are not touched.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (blocks jax and the JAX package on import)

CELLS = (8, 16, 32)


def window_stats(c: dict) -> dict:
    """Valid rows and columns, radius range, window pairs and the visits of
    a grid-indexed search, from one projection match's arguments."""
    pv, fv = c["proj_valid"], c["feat_valid"]
    n, m = pv.shape[0], fv.shape[0]
    r = c["radius"]
    r = (r.expand(n) if isinstance(r, torch.Tensor)
         else torch.full((n,), float(r), device=pv.device))
    rows, cols = pv.nonzero()[:, 0], fv.nonzero()[:, 0]
    out = {"valid_rows": int(rows.numel()), "valid_cols": int(cols.numel()),
           "level_slack": int(c["level_slack"])}
    if rows.numel() == 0 or cols.numel() == 0:
        out.update(window_pairs=0, radius_min=None, radius_max=None,
                   **{f"visits_c{cs}": 0 for cs in CELLS})
        return out
    pu, pv_ = c["proj_uv"][rows, 0], c["proj_uv"][rows, 1]
    fu, fv_ = c["feat_uv"][cols, 0], c["feat_uv"][cols, 1]
    rr = r[rows]
    d2 = (pu[:, None] - fu[None, :]) ** 2 + (pv_[:, None] - fv_[None, :]) ** 2
    lv_ok = (c["feat_level"][cols][None, :] - c["pred_level"][rows][:, None]).abs() \
        <= int(c["level_slack"])
    out["window_pairs"] = int(((d2 <= rr[:, None] ** 2) & lv_ok).sum())
    out["radius_min"], out["radius_max"] = float(rr.min()), float(rr.max())
    ar = rr.abs()
    for cs in CELLS:
        kx, ky = torch.floor(fu / cs), torch.floor(fv_ / cs)
        lox, hix = torch.floor((pu - ar) / cs) - 1, torch.floor((pu + ar) / cs) + 1
        loy, hiy = torch.floor((pv_ - ar) / cs) - 1, torch.floor((pv_ + ar) / cs) + 1
        inside = ((kx[None] >= lox[:, None]) & (kx[None] <= hix[:, None])
                  & (ky[None] >= loy[:, None]) & (ky[None] <= hiy[:, None]))
        per_row = inside.sum(1).float()
        out[f"visits_c{cs}"] = int(per_row.sum())
        if cs == 16:
            q = torch.quantile(per_row, torch.tensor([0.5, 0.9], device=per_row.device))
            out["row_visits_c16"] = [float(q[0]), float(q[1]), float(per_row.max())]
    return out


class K2Recorder(chip_smoke.K2Capture):
    """chip_smoke.K2Capture that also appends one record a call (site, n, m
    and, for the projection match, window_stats) when `record` is set."""

    def __init__(self, record: bool = True, capture: bool = True, track_call: int = 60):
        super().__init__(capture=capture, track_call=track_call)
        self.record = record
        self.records = []

    def seen(self, name, site, func, c):
        if not self.record:
            return
        rec = {"kernel": name, "site": site, "function": func}
        if name == "hamming_best_two_projection":
            rec.update(n=int(c["mp_desc"].shape[0]), m=int(c["feat_desc"].shape[0]),
                       **window_stats(c))
        else:
            rec.update(n=int(c["d1"].shape[0]), m=int(c["d2"].shape[0]),
                       valid_rows=int(c["valid1"].sum()), valid_cols=int(c["valid2"].sum()))
        self.records.append(rec)


def histogram(records: list) -> list:
    """One entry per (kernel, site, n, m): counts, ranges and sums."""
    groups = collections.OrderedDict()
    for r in records:
        groups.setdefault((r["kernel"], r["site"], r["function"], r["n"], r["m"]),
                          []).append(r)
    out = []
    for (kernel, site, func, n, m), rs in groups.items():
        rng = lambda key: ([min(x[key] for x in rs), float(np.median([x[key] for x in rs])),
                            max(x[key] for x in rs)])
        e = {"kernel": kernel, "site": site, "function": func, "n": n, "m": m,
             "calls": len(rs), "valid_rows": rng("valid_rows"), "valid_cols": rng("valid_cols")}
        if kernel == "hamming_best_two_projection":
            rad = [x for x in rs if x["radius_min"] is not None]
            e.update(level_slack=sorted({x["level_slack"] for x in rs}),
                     radius=[min(x["radius_min"] for x in rad), max(x["radius_max"] for x in rad)]
                     if rad else None,
                     window_pairs=rng("window_pairs"),
                     window_pairs_per_valid_row=float(
                         sum(x["window_pairs"] for x in rs)
                         / max(1, sum(x["valid_rows"] for x in rs))),
                     **{f"visits_c{cs}_per_valid_row": float(
                         sum(x[f"visits_c{cs}"] for x in rs)
                         / max(1, sum(x["valid_rows"] for x in rs))) for cs in CELLS},
                     row_visits_c16_p50_p90_max=[
                         float(np.median([x["row_visits_c16"][0] for x in rs if "row_visits_c16" in x] or [0])),
                         float(np.median([x["row_visits_c16"][1] for x in rs if "row_visits_c16" in x] or [0])),
                         max([x["row_visits_c16"][2] for x in rs if "row_visits_c16" in x] or [0])])
        out.append(e)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/k2_shapes")
    ap.add_argument("--no-collab", action="store_true")
    args = ap.parse_args()
    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    from multi_orbslam3_tpu_torch.dataio import synthetic
    cfg = chip_smoke.euroc_scale_config()
    seq = synthetic.make_sequence(cfg, n_frames=120, n_points=1500, seed=5,
                                  trajectory="forward")
    os.makedirs(args.out, exist_ok=True)
    passes = {}
    with K2Recorder() as rec:
        chip_smoke.drive_mono(cfg, seq, "cuda", loop_closing=True, warmup=False)
    passes["slice"] = rec
    cases = dict(rec.cases)
    if not args.no_collab:
        with chip_smoke.reproducible(), K2Recorder(capture=False) as rec_c:
            try:
                chip_smoke.phase_collab(deterministic=True)
            except Exception as e:             # the shapes are what is read here
                print(json.dumps({"collab_phase_error": repr(e)[:500]}), flush=True)
        passes["collab"] = rec_c
    summary = {}
    for pname, r in passes.items():
        summary[pname] = histogram(r.records)
        for e in summary[pname]:
            print(json.dumps({"pass": pname, "card": card["smi"], **e}), flush=True)
    with open(os.path.join(args.out, "k2_shapes.json"), "w") as f:
        json.dump({"card": card["smi"], "histogram": summary,
                   "records": {p: r.records for p, r in passes.items()}}, f)
    torch.save({k: {a: (v.cpu() if isinstance(v, torch.Tensor) else v)
                    for a, v in c.items()} for k, c in cases.items()},
               os.path.join(args.out, "k2_cases.pt"))
    print(json.dumps({"captured": {k: {a: (list(v.shape) if isinstance(v, torch.Tensor) else v)
                                       for a, v in c.items()} for k, c in cases.items()}}),
          flush=True)
    return 0 if len(cases) == 2 else 1


if __name__ == "__main__":
    sys.exit(main())
