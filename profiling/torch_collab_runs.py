"""Repeat chip_smoke.py's collab phase on one card and print its spread.

    python3 profiling/torch_collab_runs.py [--runs N] [--deterministic-runs M]
                                           [--kernels] [--trace DIR]

Runs the phase N times in one process (each on fresh clients and server;
the first also pays the first use of every code path), then M times with
the server's `deterministic` flag under chip_smoke.reproducible (torch's
deterministic algorithms), each printing its JSON line, then one `spread`
line per mode with each metric's values over the runs. --kernels first
holds K2 at the arena shapes (chip_smoke.check_k2_arena). --trace DIR
records after every server cycle each agent's server-arena keyframe ATE
(Umeyama-aligned, as the phase scores it), the keyframe ATE of the
client's own map (its foreign copies left out), the sub-maps its
keyframes lie in and the server's event counters, and after drain_gba
each arena keyframe's aligned error; it writes one JSON file a run into
DIR and prints the cycles where an agent's ATE moved by more than 5 cm. A failed gate is reported, not raised, so the spread
covers every run. Needs one NVIDIA GPU and nvcc.
"""

import argparse
import contextlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

import torch  # noqa: E402

KEYS = ("merges", "loops", "gba_runs", "gba_rejected", "gba_aborted", "kf_culled",
        "mp_culled", "total_fps_wall", "wall_s", "comm_cycle_ms_p50", "comm_cycle_ms_p90",
        "comm_cycle_ms_p99", "gn_step_ms", "obs_valid", "peak_mem_mib_run")
EVENTS = ("merges", "loops", "gba_runs", "gba_rejected", "gba_aborted", "kf_culled",
          "kf_outlier_culled", "kf_ingested")


def _aligned_errors(pose, ts, seq):
    """Per-keyframe error (m) after the Umeyama Sim3 alignment the phase
    scores with, keyframes matched to ground truth by timestamp."""
    from multi_orbslam3_tpu_torch.eval import ate
    ts_all = np.asarray(seq.timestamps) - float(seq.timestamps[0])
    fr = np.asarray([int(np.argmin(np.abs(ts_all - t))) for t in ts])
    gt = ate.camera_centers(seq.T_cw[fr])
    est = ate.camera_centers(pose)
    s, R, t = ate.umeyama_align(est, gt, True)
    err = np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=1)
    return fr, err


class Trace:
    """on_cycle hook of chip_smoke.phase_collab (see the module doc)."""

    def __init__(self):
        self.cycles, self.final = [], None

    def __call__(self, i, server, clients, seqs):
        snap = kf_snapshot(server.m)
        row = {"cycle": i, "inflight": server._gba_inflight is not None,
               **{k: server.stats.get(k, 0) for k in EVENTS}}
        final = {}
        for a, cl in enumerate(clients):
            sel = np.nonzero(snap["valid"] & (snap["agent"] == a))[0]
            own = kf_snapshot(cl.slam.m)
            osel = np.nonzero(own["valid"] & ~cl._is_foreign_kf)[0]
            row[f"a{a}"] = {"n": int(len(sel)),
                            "maps": sorted(int(x) for x in set(server.kf_map[sel].tolist()))}
            if len(sel) >= 3:
                fr, err = _aligned_errors(snap["pose"][sel], snap["ts"][sel], seqs[a])
                row[f"a{a}"]["ate"] = float(np.sqrt((err ** 2).mean()))
                if i == len(seqs[a].timestamps):
                    final[f"a{a}"] = [
                        [int(s_), int(f_), int(server.kf_map[s_]), round(float(e), 4)]
                        for s_, f_, e in zip(sel, fr, err)]
            if len(osel) >= 3:
                _, err = _aligned_errors(own["pose"][osel], own["ts"][osel], seqs[a])
                row[f"a{a}"]["client_ate"] = float(np.sqrt((err ** 2).mean()))
        self.cycles.append(row)
        if final:
            self.final = final

    def jumps(self, min_m=0.05):
        out = []
        for prev, cur in zip(self.cycles, self.cycles[1:]):
            for a in ("a0", "a1"):
                x, y = prev[a].get("ate"), cur[a].get("ate")
                if x is not None and y is not None and abs(y - x) > min_m:
                    out.append({"cycle": cur["cycle"], "agent": a, "from": round(x, 4),
                                "to": round(y, 4), **{k: cur[k] for k in EVENTS},
                                "inflight": cur["inflight"], "maps": cur[a]["maps"]})
        return out


def kf_snapshot(m):
    """Host copies of a map's keyframe validity, owner, timestamp, pose."""
    from multi_orbslam3_tpu_torch.collab.host import fetch
    return fetch(dict(valid=m.kf_valid, agent=m.kf_agent, ts=m.kf_timestamp,
                      pose=m.kf_pose))


def run_mode(n, deterministic, trace_dir, tag):
    runs, failures = [], []
    for i in range(n):
        tr = Trace() if trace_dir else None
        ctx = cs.reproducible() if deterministic else contextlib.nullcontext()
        try:
            with ctx:
                res, _ = cs.phase_collab(deterministic=deterministic, on_cycle=tr)
        except AssertionError as e:
            failures.append(f"run {i}: {e}")
            res = None
        if tr is not None:
            os.makedirs(trace_dir, exist_ok=True)
            with open(os.path.join(trace_dir, f"collab_trace_{tag}{i}.json"), "w") as f:
                json.dump({"cycles": tr.cycles, "final": tr.final}, f)
            print(json.dumps({"phase": "trace", "mode": tag, "run": i, "failed": res is None,
                              "jumps": tr.jumps()}), flush=True)
        if res is not None:
            runs.append(res)
    spread = {k: [r[k] for r in runs] for k in KEYS}
    for a in ("agent0", "agent1"):
        for k in ("frames_ok", "server_kfs", "ate_rmse", "span", "ate_over_span"):
            spread[f"{a}.{k}"] = [r[a].get(k) for r in runs]
    print(json.dumps({"phase": "spread", "mode": tag, "runs": len(runs),
                      "failures": failures, "reproducible": deterministic, **spread}),
          flush=True)
    return failures


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--deterministic-runs", type=int, default=0)
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--trace", default=None, metavar="DIR")
    args = ap.parse_args()
    card = cs.phase_device()
    cs.phase_build()
    if args.kernels:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        cs.check_k2_arena(card, gen)
    failures = run_mode(args.runs, False, args.trace, "free")
    failures += run_mode(args.deterministic_runs, True, args.trace, "det")
    print(card["smi"], flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
