"""profiling/collab_merge_record.py on the CPU: the Sim3 error of a merge
against ground truth, on two synthetic maps related by a known Sim3 (the
true estimate reads 0 within float tolerance; one with the scale 20% off
reads 0.2), each map's own Umeyama alignment to ground truth, the merge
summary's inlier medians, and the arena score with the collab phase's
gate."""

import os
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "profiling"))
import collab_merge_record as cmr  # noqa: E402


def _rot(axis, a):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def _sequence(centres):
    """A sequence stand-in: timestamps 0.05 s apart and world-to-camera
    poses whose centres are `centres`."""
    n = len(centres)
    T = np.tile(np.eye(4), (n, 1, 1))
    for i, c in enumerate(centres):
        R = _rot([0.1, 1.0, 0.2], 0.05 * i)
        T[i, :3, :3] = R
        T[i, :3, 3] = -R @ c
    return types.SimpleNamespace(timestamps=np.arange(n) * 0.05, T_cw=T)


def _map_snapshot(seq, frames, A, agent):
    """Keyframe poses of a map whose frame is the world under A^-1
    (gt = s R p + t): p = A^-1(gt); the camera orientation is kept."""
    s, R, t = A
    pose = np.tile(np.eye(4), (len(frames), 1, 1))
    for j, f in enumerate(frames):
        g = -seq.T_cw[f, :3, :3].T @ seq.T_cw[f, :3, 3]
        c = R.T @ (g - t) / s
        Rc = seq.T_cw[f, :3, :3] @ R
        pose[j, :3, :3] = Rc
        pose[j, :3, 3] = -Rc @ c
    return {"pose": pose.astype(np.float32), "ts": seq.timestamps[frames].astype(np.float32),
            "agent": np.full(len(frames), agent), "valid": np.ones(len(frames), bool)}


@pytest.fixture(scope="module")
def two_maps():
    th = np.linspace(0.0, 1.6 * np.pi, 60)
    seqs = [_sequence(np.stack([4 * np.cos(th + p), 4 * np.sin(th + p), 0.3 * np.sin(3 * th)], 1))
            for p in (0.0, 0.9)]
    A_cand = (0.7, _rot([0.3, -0.2, 1.0], 0.6), np.array([1.0, -2.0, 0.5]))
    A_cur = (2.5, _rot([1.0, 0.4, 0.1], -1.1), np.array([-0.3, 0.8, 2.0]))
    frames = np.arange(0, 60, 3)
    cand = _map_snapshot(seqs[0], frames, A_cand, 0)
    cur = _map_snapshot(seqs[1], frames, A_cur, 1)
    # the true p_cur ~ S(p_cand): A_cur^-1 o A_cand
    s = A_cand[0] / A_cur[0]
    R = A_cur[1].T @ A_cand[1]
    t = A_cur[1].T @ (A_cand[2] - A_cur[2]) / A_cur[0]
    return seqs, cand, cur, (s, R, t), (A_cand, A_cur)


def test_alignment_recovers_each_maps_sim3(two_maps):
    seqs, cand, cur, _, (A_cand, A_cur) = two_maps
    for snap, (s, R, t) in ((cand, A_cand), (cur, A_cur)):
        A = cmr.align_to_gt(snap, np.arange(len(snap["pose"])), seqs)
        assert A["s"] == pytest.approx(s, rel=1e-5)
        np.testing.assert_allclose(A["R"], R, atol=1e-5)
        np.testing.assert_allclose(A["t"], t, atol=1e-4)
    assert cmr.align_to_gt(cand, np.arange(2), seqs) is None


def _error(two_maps, S):
    seqs, cand, cur, _, _ = two_maps
    A_cand = cmr.align_to_gt(cand, np.arange(len(cand["pose"])), seqs)
    A_cur = cmr.align_to_gt(cur, np.arange(len(cur["pose"])), seqs)
    c = np.einsum("ji,j->i", -cand["pose"][7, :3, :3], cand["pose"][7, :3, 3]).astype(float)
    return cmr.sim3_error(S, A_cur, A_cand, c)


def test_the_true_sim3_reads_zero(two_maps):
    err = _error(two_maps, two_maps[3])
    assert abs(err["scale_err"]) < 1e-5
    assert err["rot_err_deg"] < 1e-3
    assert err["trans_err_over_span"] < 1e-5
    assert err["s_true"] == pytest.approx(0.7 / 2.5, rel=1e-5)


def test_a_20_percent_scale_error_reads_0_2(two_maps):
    s, R, t = two_maps[3]
    err = _error(two_maps, (1.2 * s, R, t))
    assert err["scale_err"] == pytest.approx(0.2, abs=1e-5)
    assert err["rot_err_deg"] < 1e-3
    assert err["trans_err_over_span"] > 0.01


def test_a_rotation_error_reads_in_degrees(two_maps):
    s, R, t = two_maps[3]
    err = _error(two_maps, (s, _rot([0.0, 0.0, 1.0], np.radians(5.0)) @ R, t))
    assert err["rot_err_deg"] == pytest.approx(5.0, abs=1e-3)
    assert abs(err["scale_err"]) < 1e-5


def test_summary_medians_around_the_first_merge():
    rec = cmr.MergeRecord(lc=None)
    rec.cascades = [
        {"cycle": 30, "accepted": None, "ok": False, "inliers": 9, "n_proj": 12},
        {"cycle": 52, "accepted": "merge", "ok": True, "agent_cur": 1, "agent_cand": 0,
         "inliers": 12, "n_proj": 40, "scale_err": 0.25, "rot_err_deg": 1.0,
         "trans_err_over_span": 0.02},
        {"cycle": 90, "accepted": "loop", "ok": True, "inliers": 30, "n_proj": 80}]
    rec.inliers = [[], [(f, 300 if f <= 52 else 100 + f % 3, 0) for f in range(20, 80)]]
    s = rec.summary()
    assert [e["cycle"] for e in s["events"]] == [52, 90]
    assert s["events"][0]["inliers"] == 12 and s["events"][0]["scale_err"] == 0.25
    assert s["ransac_passed"] == 3 and s["cascades_ok"] == 2 and s["first_merge_cycle"] == 52
    assert s["a1_own_inliers_median_before"] == 300.0
    assert s["a1_own_inliers_median_after"] == 101.0


def test_score_applies_the_phase_gate(two_maps):
    seqs, cand, cur, _, _ = two_maps
    arena = {k: np.concatenate([cand[k], cur[k]]) for k in ("pose", "ts", "agent", "valid")}
    m = types.SimpleNamespace(kf_valid=arena["valid"], kf_agent=arena["agent"],
                              kf_timestamp=arena["ts"], kf_pose=arena["pose"])
    server = types.SimpleNamespace(m=m)
    states = [["OK"] * 150, ["OK"] * 150]
    res = cmr.score(server, seqs, states, "OK")
    assert not res["failed"]
    assert res["agent0"]["ate_rmse"] < 1e-4 and res["agent0"]["server_kfs"] == 20
    # one keyframe of agent 1 two metres off fails its gate
    pose = arena["pose"].copy()
    pose[25, :3, 3] += pose[25, :3, :3] @ np.array([2.0, 0.0, 0.0]) / 2.5
    server.m = types.SimpleNamespace(kf_valid=arena["valid"], kf_agent=arena["agent"],
                                     kf_timestamp=arena["ts"], kf_pose=pose)
    res = cmr.score(server, seqs, states, "OK")
    assert res["failed"] and res["failed_agents"] == ["agent1"]
