"""Repeat chip_smoke.py's collab phase on one card and print its spread.

    python3 profiling/torch_collab_runs.py [--runs N] [--fixed-runs K]
                                           [--deterministic-runs M] [--seeds 31,32]
                                           [--kernels] [--trace DIR] [--record DIR]
                                           [--dump DIR] [--inertial] [--frames F]

--inertial repeats the collab_inertial phase instead (a mono-inertial and
a mono agent, tests/test_collab_inertial.py's drill at full width, F
frames an agent), and prints after each run a `gate_curve` line: the
drill's gates after every frame from 90 on, as if the run had ended
there, and the first frame count at which all of them pass. Runs
the phase N times in one process (each on fresh clients and server;
the first also pays the first use of every code path), then K times with
the server's `deterministic` flag (the GBA's schedule fixed, float
atomics free), then M times with the flag under chip_smoke.reproducible
(torch's deterministic algorithms), each printing its JSON line, then one
`spread` line per mode with each metric's values over the runs; all of it
for each of --seeds (the collab sequence's seed). --record DIR writes
each collab run's merge record (profiling/collab_merge_record.py) with
the phase's result to DIR and prints a `record` line a run: each agent's
ATE, whether the ATE gate (0.02 x max(span, 1)) failed, and the merge
summary. --dump DIR dumps the state at the first accepted merge of the
first deterministic run of the first seed for
profiling/collab_merge_replay.py. --kernels first
holds K2 at the arena shapes (chip_smoke.check_k2_arena). --trace DIR
records after every server cycle each agent's server-arena keyframe ATE
(Umeyama-aligned, as the phase scores it), the keyframe ATE of the
client's own map (its foreign copies left out), the sub-maps its
keyframes lie in and the server's event counters, and after drain_gba
each arena keyframe's aligned error. For each client and frame it also
records the pose optimisation's inliers on the client's own landmarks and
on foreign ones (copies of other agents' landmarks), the error of the live
pose after the alignment of the client's own keyframes, and whether a
correction batch or a gauge was applied in that cycle. It writes one JSON
file a run into DIR and prints the cycles where an agent's ATE moved by
more than 5 cm and the first cycle where a live pose was more than 0.2 m
off. A failed gate is reported, not raised, and the failed run's numbers
stay in the spread. Needs one NVIDIA GPU and nvcc.
"""

import argparse
import contextlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def _cs():
    """chip_smoke, imported on first use: profiling/collab_merge_record.py
    imports this module from chip_smoke.phase_collab and from the JAX
    package's CPU runs."""
    import chip_smoke
    return chip_smoke

KEYS = ("merges", "loops", "gba_runs", "gba_rejected", "gba_aborted", "kf_culled",
        "mp_culled", "total_fps_wall", "wall_s", "comm_cycle_ms_p50", "comm_cycle_ms_p90",
        "comm_cycle_ms_p99", "gn_step_ms", "obs_valid", "peak_mem_mib_run")
INERTIAL_KEYS = ("merges", "gba_runs", "gba_rejected", "vi_solves", "vi_pts_truncated",
                 "imu_init_frame", "imu_init_scale", "vi_ate_rmse", "span", "tilt_mean_deg",
                 "tilt_head_deg", "tilt_tail_deg", "mono_ate_rmse", "frames_ok",
                 "total_fps_wall", "wall_s", "comm_cycle_ms_p50", "comm_cycle_ms_p90",
                 "comm_cycle_ms_p99", "full_inertial_ba_ms", "bytes_up", "bytes_down",
                 "peak_mem_mib_run")
EVENTS = ("merges", "loops", "gba_runs", "gba_rejected", "gba_aborted", "kf_culled",
          "kf_outlier_culled", "kf_ingested")


def umeyama(src: np.ndarray, dst: np.ndarray) -> tuple:
    """(s, R, t) with dst ~ s R src + t (eval/ate.py's alignment)."""
    from multi_orbslam3_tpu_torch.eval import ate
    return ate.umeyama_align(src, dst, True)


def _aligned_errors(pose, ts, seq, live=None):
    """Per-keyframe error (m) after the Umeyama Sim3 alignment the phase
    scores with, keyframes matched to ground truth by timestamp; with
    live = (T_cw, frame), also that pose's error under the same alignment."""
    from multi_orbslam3_tpu_torch.eval import ate
    ts_all = np.asarray(seq.timestamps) - float(seq.timestamps[0])
    fr = np.asarray([int(np.argmin(np.abs(ts_all - t))) for t in ts])
    gt = ate.camera_centers(seq.T_cw[fr])
    est = ate.camera_centers(pose)
    s, R, t = ate.umeyama_align(est, gt, True)
    err = np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=1)
    if live is None:
        return fr, err
    c = ate.camera_centers(live[0][None])[0]
    g = ate.camera_centers(seq.T_cw[live[1]][None])[0]
    return fr, err, float(np.linalg.norm(s * (R @ c) + t - g))


def _count_inliers(client, log):
    """Wrap client.slam._refine_pose, which sees every accepted frame's
    final matches, to log (frame, inliers on own, inliers on foreign)."""
    slam = client.slam
    inner = slam._refine_pose

    def refine(feats, res):
        out = inner(feats, res)
        fm = out.feat_mp
        fm = fm.cpu().numpy() if isinstance(fm, torch.Tensor) else np.asarray(fm)
        fm = fm[fm >= 0]
        n_f = int(client._is_foreign_mp[fm].sum())
        log.append((slam.frame_id, int(len(fm) - n_f), n_f))
        return out
    slam._refine_pose = refine


class Trace:
    """on_cycle hook of chip_smoke.phase_collab (see the module doc)."""

    def __init__(self):
        self.cycles, self.final = [], None
        self.inliers = None
        self.prev = {}

    def __call__(self, i, server, clients, seqs):
        if self.inliers is None:
            self.inliers = [[] for _ in clients]
            for cl, log in zip(clients, self.inliers):
                _count_inliers(cl, log)
        snap = kf_snapshot(server.m)
        row = {"cycle": i, "inflight": server._gba_inflight is not None,
               **{k: server.stats.get(k, 0) for k in EVENTS}}
        final = {}
        for a, cl in enumerate(clients):
            ev = (cl.stats["corrections_applied"], cl.stats.get("gauges_applied", 0))
            last = self.inliers[a][-1] if self.inliers[a] else None
            sel = np.nonzero(snap["valid"] & (snap["agent"] == a))[0]
            own = kf_snapshot(cl.slam.m)
            osel = np.nonzero(own["valid"] & ~cl._is_foreign_kf)[0]
            row[f"a{a}"] = {"n": int(len(sel)),
                            "maps": sorted(int(x) for x in set(server.kf_map[sel].tolist())),
                            "state": cl.slam.state.name,
                            "kf_inserted": cl.slam.stats["kf_inserted"],
                            "corrected": ev[0] != self.prev.get(a, (0, 0))[0],
                            "gauged": ev[1] != self.prev.get(a, (0, 0))[1],
                            "inl_own": None, "inl_foreign": None}
            self.prev[a] = ev
            if last is not None and last[0] == cl.slam.frame_id:
                row[f"a{a}"]["inl_own"], row[f"a{a}"]["inl_foreign"] = last[1], last[2]
            if len(sel) >= 3:
                fr, err = _aligned_errors(snap["pose"][sel], snap["ts"][sel], seqs[a])
                row[f"a{a}"]["ate"] = float(np.sqrt((err ** 2).mean()))
                if i == len(seqs[a].timestamps):
                    final[f"a{a}"] = [
                        [int(s_), int(f_), int(server.kf_map[s_]), round(float(e), 4)]
                        for s_, f_, e in zip(sel, fr, err)]
            if len(osel) >= 3 and i < len(seqs[a].timestamps):
                _, err, live = _aligned_errors(own["pose"][osel], own["ts"][osel], seqs[a],
                                               live=(cl.slam.T_cur, i))
                row[f"a{a}"]["client_ate"] = float(np.sqrt((err ** 2).mean()))
                row[f"a{a}"]["live_err"] = live
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

    def first_live_drift(self, min_m=0.2):
        """Per agent, the first cycle whose live pose is min_m off, with the
        ten cycles before it (inliers own/foreign, corrections, gauges)."""
        out = {}
        for a in ("a0", "a1"):
            rows = [r for r in self.cycles if r[a].get("live_err") is not None]
            hit = next((j for j, r in enumerate(rows) if r[a]["live_err"] > min_m), None)
            if hit is None:
                continue
            out[a] = [{"cycle": r["cycle"], **{k: r[a][k] for k in (
                "live_err", "inl_own", "inl_foreign", "corrected", "gauged", "state",
                "kf_inserted")}} for r in rows[max(0, hit - 10):hit + 3]]
        return out


class GateCurve:
    """on_cycle hook of chip_smoke.phase_collab_inertial: after every frame
    from `first` on, the drill's gates as if the run had ended there (the
    sequence and the run are causal; the final drain_gba is left out)."""

    def __init__(self, first=90, inner=None):
        self.first, self.inner, self.rows = first, inner, []
        self.sent_before_init = 0

    def __call__(self, i, server, clients, seqs):
        if self.inner is not None:
            self.inner(i, server, clients, seqs)
        if not clients[0].slam.inertial_ready:
            self.sent_before_init = clients[0].stats["deltas_sent"]
        if i + 1 < self.first:
            return
        gates, problems = _cs().collab_inertial_gates(server, clients, seqs, i + 1,
                                                   self.sent_before_init)
        self.rows.append({"frames": i + 1, "passed": not problems, **{k: gates.get(k) for k in (
            "imu_init_frame", "vi_ate_rmse", "span", "tilt_mean_deg", "tilt_head_deg",
            "tilt_tail_deg", "mono_ate_rmse")}, "problems": problems})


def kf_snapshot(m):
    """Host copies of a map's keyframe validity, owner, timestamp, pose (a
    map of either package)."""
    d = dict(valid=m.kf_valid, agent=m.kf_agent, ts=m.kf_timestamp, pose=m.kf_pose)
    if not isinstance(m.kf_valid, torch.Tensor):
        return {k: np.asarray(v) for k, v in d.items()}
    from multi_orbslam3_tpu_torch.collab.host import fetch
    return fetch(d)


# mode -> (the server's deterministic flag, torch's deterministic algorithms)
MODES = {"free": (False, False), "fixed": (True, False), "det": (True, True)}


def run_mode(n, mode, trace_dir, tag, inertial=False, frames=None, seed=31,
             record_dir=None, dump_dir=None):
    """n runs of one mode: "free" (free-running), "fixed" (the server's
    deterministic flag: the GBA's schedule fixed, float atomics free) or
    "det" (the flag under chip_smoke.reproducible)."""
    runs, failures = [], []
    cs = _cs()
    flag, repro = MODES[mode]
    phase = cs.phase_collab_inertial if inertial else cs.phase_collab
    kw = {} if frames is None else {"n_frames": frames}
    if not inertial:
        kw["seed"] = seed
    for i in range(n):
        tr = Trace() if trace_dir else None
        if record_dir and not inertial:
            import collab_merge_record
            from multi_orbslam3_tpu_torch.pipeline import loop_closing
            on_merge = None
            if dump_dir and i == 0:
                import collab_merge_replay
                on_merge = collab_merge_replay.Dumper(dump_dir, seed)
            tr = collab_merge_record.MergeRecord(loop_closing, on_merge=on_merge)
        curve = GateCurve(inner=tr) if inertial else None
        ctx = cs.reproducible() if repro else contextlib.nullcontext()
        try:
            with ctx:
                res, _ = phase(deterministic=flag, on_cycle=curve or tr, **kw)
        except AssertionError as e:
            failures.append(f"run {i}: {e}")
            res = getattr(e, "res", None)       # a failed gate keeps its numbers
        failed = any(f.startswith(f"run {i}:") for f in failures)
        if record_dir and not inertial:
            os.makedirs(record_dir, exist_ok=True)
            ate_failed = [a for a in ("agent0", "agent1") if res is None
                          or not res[a].get("ate_rmse", np.inf)
                          < 0.02 * max(res[a].get("span", 1.0), 1.0)]
            line = {"phase": "record", "mode": tag + mode, "seed": seed, "run": i,
                    "failed": failed, "ate_failed": ate_failed,
                    **{a: {k: (res or {}).get(a, {}).get(k) for k in (
                        "frames_ok", "server_kfs", "ate_rmse", "span", "ate_over_span")}
                       for a in ("agent0", "agent1")},
                    **{k: (res or {}).get(k) for k in ("merges", "loops", "gba_runs",
                                                       "gba_rejected", "gba_aborted",
                                                       "wall_s")},
                    "merge": tr.summary()}
            with open(os.path.join(record_dir, f"collab_record_{tag}{mode}_s{seed}_{i}.json"),
                      "w") as f:
                json.dump({**line, "result": res, "record": tr.to_json()}, f, default=float)
            print(json.dumps(line, default=float), flush=True)
        elif tr is not None:
            os.makedirs(trace_dir, exist_ok=True)
            with open(os.path.join(trace_dir, f"collab_trace_{tag}{mode}{i}.json"), "w") as f:
                json.dump({"cycles": tr.cycles, "final": tr.final}, f)
            print(json.dumps({"phase": "trace", "mode": tag + mode, "run": i, "failed": failed,
                              "jumps": tr.jumps(),
                              "live_drift": tr.first_live_drift()}), flush=True)
        if curve is not None:
            print(json.dumps({"phase": "gate_curve", "mode": tag + mode, "run": i,
                              "first_passing": next((r["frames"] for r in curve.rows
                                                     if r["passed"]), None),
                              "rows": curve.rows}), flush=True)
        if res is not None:
            runs.append(res)
    spread = {k: [r.get(k) for r in runs] for k in (INERTIAL_KEYS if inertial else KEYS)}
    for a in () if inertial else ("agent0", "agent1"):
        for k in ("frames_ok", "server_kfs", "ate_rmse", "span", "ate_over_span"):
            spread[f"{a}.{k}"] = [r[a].get(k) for r in runs]
    print(json.dumps({"phase": "spread", "mode": tag + mode, "seed": seed, "runs": len(runs),
                      "drill": "collab_inertial" if inertial else "collab",
                      "failures": failures, "server_deterministic": flag,
                      "reproducible": repro, **spread}), flush=True)
    return failures


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2, help="free-running runs")
    ap.add_argument("--fixed-runs", type=int, default=0,
                    help="runs with the server's deterministic flag, float atomics free")
    ap.add_argument("--deterministic-runs", type=int, default=0)
    ap.add_argument("--seeds", default="31", help="comma-separated sequence seeds (collab)")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--trace", default=None, metavar="DIR")
    ap.add_argument("--record", default=None, metavar="DIR",
                    help="the merge record of every run (collab_merge_record.py)")
    ap.add_argument("--dump", default=None, metavar="DIR",
                    help="dump the state at the first merge of the first "
                         "deterministic run of the first seed (collab_merge_replay.py)")
    ap.add_argument("--inertial", action="store_true")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames an agent (default: the phase's own)")
    args = ap.parse_args()
    cs = _cs()
    card = cs.phase_device()
    cs.phase_build()
    if args.kernels:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        cs.check_k2_arena(card, gen)
    tag = "inertial_" if args.inertial else ""
    failures = []
    for j, seed in enumerate(int(x) for x in args.seeds.split(",")):
        common = dict(inertial=args.inertial, frames=args.frames, seed=seed,
                      record_dir=args.record)
        failures += run_mode(args.runs, "free", args.trace, tag, **common)
        failures += run_mode(args.fixed_runs, "fixed", args.trace, tag, **common)
        failures += run_mode(args.deterministic_runs, "det", args.trace, tag,
                             dump_dir=args.dump if j == 0 else None, **common)
    print(card["smi"], flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
