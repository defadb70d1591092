"""One record of a collaborative run's merges, for either package.

    from collab_merge_record import MergeRecord      # profiling/ on sys.path

`MergeRecord(lc)` is an on_cycle hook (chip_smoke.phase_collab's, or the
loop of profiling/jax_collab_cpu.py): `lc` is the package's
pipeline.loop_closing module, whose verify_candidate_cascade the server
calls. On the first call it wraps that function (restored by close()),
the server's _merge_maps and each client's slam._refine_pose, so neither
package is edited. It records:

- every cascade whose Sim3 RANSAC passed (`cascades`): the cycle, the two
  keyframe slots, their agents and sub-maps, the RANSAC inliers
  (lm.valid & inliers), n_proj, whether the cascade passed and whether the
  server accepted it as a merge or a loop; and the Sim3's error against
  ground truth. Just before the event each side is aligned to ground truth
  by Umeyama (keyframes matched by timestamp): for a merge each sub-map's
  keyframes, for a same-map loop the 10 keyframes nearest in time to each
  slot (for a merge also, as `*_local`, since a monocular map's scale
  drifts along it). With gt ~ A(p), the true relative Sim3 is A_cur^-1 A_cand
  (p_cur ~ S(p_cand), the cascade's convention), and the record holds the
  estimate's scale ratio minus 1, its rotation error in degrees and the
  distance between the estimate's and the truth's image of the candidate
  keyframe's centre over the current side's span;
- for every client frame, the pose optimisation's inliers on the client's
  own and on foreign landmarks (torch_collab_runs.Trace's `inliers`);
- with cycles=True, after every server cycle the Trace row: each agent's
  server-arena keyframe ATE, whether a correction batch or a gauge was
  applied on each client, the server's counters (gba_runs counts adopted
  GBAs) and `gba_adopted`.

`summary()` gives the accepted events (inliers, n_proj, scale, rotation
and translation errors) and agent 1's median own-landmark inliers over
the 20 frames before and after the first merge. `score()` scores a
server arena as chip_smoke.phase_collab and bench_collab do.

    python profiling/collab_merge_record.py FILE_OR_DIR ...

tabulates record files (profiling/torch_collab_runs.py --record's
collab_record_*.json, profiling/jax_collab_cpu.py's --out): one JSON line a
run (package, mode, seed, each agent's ATE / span, failed or not, the
accepted events' inliers, n_proj and Sim3 errors, agent 1's own-landmark
medians), then one line a (package, mode, seed) with the failure count and
the events of the failing and the passing runs.
"""

import glob
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_collab_runs as tcr  # noqa: E402


def to_host(x) -> np.ndarray:
    """A torch tensor (any device) or a JAX / numpy array as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _centres(pose: np.ndarray) -> np.ndarray:
    return np.einsum("nji,nj->ni", -pose[:, :3, :3], pose[:, :3, 3])


def _gt_frames(ts: np.ndarray, seq) -> np.ndarray:
    ts_all = np.asarray(seq.timestamps) - float(seq.timestamps[0])
    return np.asarray([int(np.argmin(np.abs(ts_all - t))) for t in ts])


def align_to_gt(snap: dict, sel: np.ndarray, seqs):
    """Umeyama (s, R, t) with gt ~ s R c + t of the keyframe centres in sel
    (each matched to its agent's sequence by timestamp); None under 3."""
    if len(sel) < 3:
        return None
    est = _centres(snap["pose"][sel].astype(np.float64))
    gt = np.zeros_like(est)
    for a in np.unique(snap["agent"][sel]):
        rows = snap["agent"][sel] == a
        fr = _gt_frames(snap["ts"][sel][rows], seqs[int(a)])
        gt[rows] = _centres(np.asarray(seqs[int(a)].T_cw[fr], np.float64))
    s, R, t = tcr.umeyama(est, gt)
    span = float(np.linalg.norm(est.max(0) - est.min(0)))
    return {"s": s, "R": R, "t": t, "n": int(len(sel)), "span": span}


def sim3_error(S_est, A_cur, A_cand, c_cand: np.ndarray) -> dict:
    """The error of S_est = (s, R, t) (p_cur ~ s R p_cand + t) against the
    relative Sim3 of two ground-truth alignments A (gt ~ s R p + t)."""
    s_e, R_e, t_e = S_est
    s_t = A_cand["s"] / A_cur["s"]
    R_t = A_cur["R"].T @ A_cand["R"]
    t_t = A_cur["R"].T @ (A_cand["t"] - A_cur["t"]) / A_cur["s"]
    dR = R_e @ R_t.T
    rot = float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0))))
    moved = np.linalg.norm((s_e * R_e @ c_cand + t_e) - (s_t * R_t @ c_cand + t_t))
    return {"s_est": float(s_e), "s_true": float(s_t), "scale_err": float(s_e / s_t - 1.0),
            "rot_err_deg": rot, "trans_err_over_span": float(moved / max(A_cur["span"], 1e-9))}


def score(server, seqs, states, ok_state) -> dict:
    """Each agent's server-arena keyframe ATE as chip_smoke.phase_collab and
    eval/benchmarks.py::bench_collab score it, and the phase's gate
    (ATE < 0.02 x max(span, 1), >= 8 server keyframes, >= 120 frames OK)."""
    snap = tcr.kf_snapshot(server.m)
    out, failed = {}, []
    for a, seq in enumerate(seqs):
        sel = np.nonzero(snap["valid"] & (snap["agent"] == a))[0]
        acc = {"server_kfs": int(len(sel)),
               "frames_ok": int(sum(st == ok_state for st in states[a]))}
        if len(sel) >= 8:
            gt = _centres(np.asarray(seq.T_cw[_gt_frames(snap["ts"][sel], seq)], np.float64))
            est = _centres(snap["pose"][sel].astype(np.float64))
            s, R, t = tcr.umeyama(est, gt)
            rmse = float(np.sqrt(np.mean(np.sum(((s * (R @ est.T)).T + t - gt) ** 2, 1))))
            span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
            acc.update(ate_rmse=rmse, span=span, ate_over_span=rmse / span)
            if not rmse < 0.02 * max(span, 1.0):
                failed.append(f"agent{a}")
        else:
            failed.append(f"agent{a}")
        if acc["frames_ok"] < 120 and len(states[a]) >= 150:
            failed.append(f"agent{a}")
        out[f"agent{a}"] = acc
    out["failed_agents"] = sorted(set(failed))
    out["failed"] = bool(failed)
    return out


class MergeRecord(tcr.Trace):
    """on_cycle hook; see the module doc. on_merge(server, clients,
    kf_cur, kf_cand, S, casc, cycle) is called at the first accepted merge
    just before the server applies it (collab_merge_replay.dump)."""

    def __init__(self, lc, cycles: bool = True, on_merge=None):
        super().__init__()
        self.lc, self.trace_cycles, self.on_merge = lc, cycles, on_merge
        self.cascades, self._pending, self._last_ok = [], [], None
        self.server = self.clients = self.seqs = None
        self._restore = []
        self.cycle = 0
        self._prev = {"loops": 0, "gba_runs": 0}

    # --------------------------------------------------------------
    def install(self, server, clients, seqs) -> None:
        self.server, self.clients, self.seqs = server, clients, seqs
        self.inliers = [[] for _ in clients]
        for cl, log in zip(clients, self.inliers):
            tcr._count_inliers(cl, log)
        inner_v = self.lc.verify_candidate_cascade

        def verify(m, kf_cur, kf_cand, *a, **kw):
            casc = inner_v(m, kf_cur, kf_cand, *a, **kw)
            if casc.S is not None:
                self._pending.append(self._cascade(m, int(kf_cur), int(kf_cand), casc))
                if casc.ok:
                    self._last_ok = (int(kf_cur), int(kf_cand), casc)
            return casc
        self.lc.verify_candidate_cascade = verify
        self._restore.append(lambda: setattr(self.lc, "verify_candidate_cascade", inner_v))
        inner_m = server._merge_maps

        def merge_maps(kf_cur, kf_cand, S_loop):
            pair = {int(kf_cur), int(kf_cand)}
            for rec in reversed(self._pending):
                if rec["ok"] and {rec["kf_cur"], rec["kf_cand"]} == pair:
                    rec["accepted"] = "merge"
                    break
            first = not any(r.get("accepted") == "merge" for r in self.cascades)
            if first and self.on_merge is not None and self._last_ok is not None:
                self.on_merge(server, clients, int(kf_cur), int(kf_cand), S_loop,
                              self._last_ok[2], self.cycle)
            return inner_m(kf_cur, kf_cand, S_loop)
        server._merge_maps = merge_maps

    def _cascade(self, m, kf_cur: int, kf_cand: int, casc) -> dict:
        snap = tcr.kf_snapshot(m)
        kf_map = np.asarray(self.server.kf_map)
        valid = snap["valid"]
        n_inl = int(np.sum(to_host(casc.lm.valid) & to_host(casc.inliers)))
        rec = {"cycle": self.cycle, "kf_cur": kf_cur, "kf_cand": kf_cand,
               "agent_cur": int(snap["agent"][kf_cur]), "agent_cand": int(snap["agent"][kf_cand]),
               "map_cur": int(kf_map[kf_cur]), "map_cand": int(kf_map[kf_cand]),
               "inliers": n_inl, "n_proj": int(casc.n_proj), "ok": bool(casc.ok),
               "accepted": None}
        local = []
        for k in (kf_cur, kf_cand):
            own = np.nonzero(valid & (kf_map == kf_map[k]) & (snap["agent"] == snap["agent"][k]))[0]
            near = np.argsort(np.abs(snap["ts"][own] - snap["ts"][k]), kind="stable")
            local.append(np.sort(own[near[:10]]))
        whole = [np.nonzero(valid & (kf_map == kf_map[k]))[0] for k in (kf_cur, kf_cand)]
        S = (float(to_host(casc.S.s)), to_host(casc.S.R).astype(np.float64),
             to_host(casc.S.t).astype(np.float64))
        c_cand = _centres(snap["pose"][kf_cand][None].astype(np.float64))[0]
        # a merge against each sub-map's alignment, a loop (and, as
        # *_local, a merge too) against the 10 keyframes nearest each slot:
        # a monocular map's scale drifts along it
        for sides, tag in (([] if rec["map_cur"] == rec["map_cand"] else [(whole, "")])
                           + [(local, "" if rec["map_cur"] == rec["map_cand"] else "_local")]):
            A_cur, A_cand = (align_to_gt(snap, s_, self.seqs) for s_ in sides)
            if A_cur is None or A_cand is None:
                continue
            err = sim3_error(S, A_cur, A_cand, c_cand)
            rec.update({k + tag: v for k, v in err.items() if k != "s_est"}, s_est=err["s_est"])
            rec.update({"kfs_cur" + tag: A_cur["n"], "kfs_cand" + tag: A_cand["n"]})
        return rec

    # --------------------------------------------------------------
    def __call__(self, i, server, clients, seqs):
        if self.server is None:
            self.install(server, clients, seqs)
        st = server.stats
        new_loops = st.get("loops", 0) - self._prev["loops"]
        for rec in reversed(self._pending):
            if new_loops <= 0:
                break
            if rec["ok"] and rec["accepted"] is None and rec["map_cur"] == rec["map_cand"]:
                rec["accepted"] = "loop"
                new_loops -= 1
        self.cascades.extend(self._pending)
        self._pending = []
        adopted = st.get("gba_runs", 0) != self._prev["gba_runs"]
        self._prev = {"loops": st.get("loops", 0), "gba_runs": st.get("gba_runs", 0)}
        if self.trace_cycles:
            super().__call__(i, server, clients, seqs)
            self.cycles[-1]["gba_adopted"] = adopted
        self.cycle = i + 1

    def close(self) -> None:
        for undo in self._restore:
            undo()
        self._restore = []

    # --------------------------------------------------------------
    def events(self) -> list:
        return [r for r in self.cascades if r["accepted"]]

    def summary(self) -> dict:
        keys = ("cycle", "accepted", "agent_cur", "agent_cand", "inliers", "n_proj",
                "scale_err", "rot_err_deg", "trans_err_over_span", "scale_err_local",
                "rot_err_deg_local")
        ev = [{k: r.get(k) for k in keys} for r in self.events()]
        first = next((r["cycle"] for r in self.events() if r["accepted"] == "merge"), None)
        out = {"events": ev, "ransac_passed": len(self.cascades),
               "cascades_ok": sum(r["ok"] for r in self.cascades), "first_merge_cycle": first,
               "a1_own_inliers_median_before": None, "a1_own_inliers_median_after": None}
        if first is not None and self.inliers and len(self.inliers) > 1:
            log = self.inliers[1]
            before = [o for f, o, _ in log if first - 20 < f <= first]
            after = [o for f, o, _ in log if first < f <= first + 20]
            if before:
                out["a1_own_inliers_median_before"] = float(np.median(before))
            if after:
                out["a1_own_inliers_median_after"] = float(np.median(after))
        return out

    def to_json(self) -> dict:
        return {"cascades": self.cascades, "cycles": self.cycles, "final": self.final,
                "inliers": self.inliers, "summary": self.summary()}


# ----------------------------------------------------------------------
def _row(path: str) -> dict:
    with open(path) as f:
        d = json.load(f)
    if d.get("package") == "jax":
        mode = "flag_on" if d["server_deterministic"] else "flag_off"
        agents, failed, summ = d, d["failed"], d["merge_summary"]
        seed, package, seconds = d["seed"], "jax", d["seconds"]
    else:
        mode, agents, summ = d["mode"], d, d["merge"]
        failed, seed, package = bool(d["ate_failed"]), d["seed"], "port"
        seconds = d.get("wall_s")
    return {"file": os.path.basename(path), "package": package, "mode": mode, "seed": seed,
            "failed": failed, "seconds": seconds,
            **{a: agents[a].get("ate_over_span") for a in ("agent0", "agent1")},
            "events": [(e["accepted"], e["cycle"], e["inliers"], e["n_proj"],
                        None if e.get("scale_err") is None else round(e["scale_err"], 4),
                        None if e.get("rot_err_deg") is None else round(e["rot_err_deg"], 3))
                       for e in summ["events"]],
            "a1_own_before": summ["a1_own_inliers_median_before"],
            "a1_own_after": summ["a1_own_inliers_median_after"]}


def main(paths) -> int:
    files = []
    for p in paths:
        files += sorted(glob.glob(os.path.join(p, "*.json"))) if os.path.isdir(p) else [p]
    rows = [_row(f) for f in files]
    groups = {}
    for r in rows:
        print(json.dumps(r), flush=True)
        groups.setdefault((r["package"], r["mode"], r["seed"]), []).append(r)
    for (package, mode, seed), rs in sorted(groups.items()):
        print(json.dumps({"package": package, "mode": mode, "seed": seed, "runs": len(rs),
                          "failed": sum(r["failed"] for r in rs),
                          "failing_events": [r["events"] for r in rs if r["failed"]],
                          "passing_events": [r["events"] for r in rs if not r["failed"]]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
