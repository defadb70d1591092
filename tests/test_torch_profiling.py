"""The port's profilers (multi_orbslam3_tpu_torch/profiling/) on the CPU:
their formulations against the JAX package's on the same numpy arrays,
their main functions at a small size, and the mono profiler's hooks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.map import mapstate as jms
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch.map import mapstate as tms
from multi_orbslam3_tpu_torch.pipeline import tracking
from multi_orbslam3_tpu_torch.profiling import (common, profile_ab_u8, profile_covis,
                                                profile_mono, profile_scatter,
                                                profile_stages)

torch.set_num_threads(2)
CPU = torch.device("cpu")


def small_config():
    return tcfg.synthetic_mono(width=320, height=240).replace(
        orb=tcfg.ORBConfig(n_features=256, n_levels=4),
        map=tcfg.MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                           max_obs_per_kf=256),
        local_mapping=tcfg.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                              local_ba_points=1024, local_ba_iters=8))


# ----------------------------------------------------------------------
# profile_covis: the formulations and both packages' covisibility_row
# ----------------------------------------------------------------------

def test_covis_formulations_agree_with_both_packages():
    """At K=16, N=64, P=512 every formulation equals the numpy count of
    its kind exactly; the per-feature ones equal both packages'
    covisibility_row without the query's own entry."""
    K, N, P, q = 16, 64, 512, profile_covis.QUERY
    a = profile_covis.inputs(K, N, P)
    kf_mp, fv = torch.from_numpy(a["kf_mp"]), torch.from_numpy(a["fv"])
    kv, mv = torch.ones(K, dtype=torch.bool), torch.ones(P, dtype=torch.bool)
    per_feature, distinct = profile_covis.reference_counts(a["kf_mp"], a["fv"], P, q)
    assert (per_feature != distinct).any()        # the inputs repeat landmarks in rows
    got = {n: f(kf_mp, fv, kv, mv, q).numpy() for n, f in profile_covis.FORMULATIONS.items()}
    np.testing.assert_array_equal(got["mask_matvec"], distinct)
    for n in ("gather_bool", "gather_f32", "onehot_scan"):
        np.testing.assert_array_equal(got[n], per_feature, err_msg=n)
    mj = jms.empty_map(K, P, N)._replace(
        kf_mp=jnp.asarray(a["kf_mp"]), kf_feat_valid=jnp.asarray(a["fv"]),
        kf_valid=jnp.ones(K, bool), mp_valid=jnp.ones(P, bool))
    row_j = np.asarray(jms.covisibility_row(mj, jnp.int32(q)))
    row_t = tms.covisibility_row(profile_covis.as_map(kf_mp, fv, P), q).numpy()
    others = np.arange(K) != q
    np.testing.assert_array_equal(row_t, row_j)
    np.testing.assert_array_equal(row_t[others], per_feature[others])
    assert row_t[q] == 0


def test_profile_covis_runs_and_reports_agreement():
    out = profile_covis.run(K=16, N=64, P=512, reps=2, arena=(64, 32, 700), device="cpu")
    assert out["all_agree"] and out["rows_where_kinds_differ"] > 0
    assert set(out["formulations"]) == set(profile_covis.FORMULATIONS) | {"covisibility_row"}
    arena = out["covisibility_matrix_arena"]
    assert arena["chunks_agree"] and arena["chunk_8192"]["peak_mib"] is None
    assert all(r["launches"] is None and r["device_ms"] is None
               for r in out["formulations"].values())


# ----------------------------------------------------------------------
# profile_scatter: the assemblies against JAX's .at[].add
# ----------------------------------------------------------------------

def test_scatter_assemblies_match_jax():
    """Kw=4, N=64, Pw=128, the profile's own arrays: index_add and the
    float32 one-hot within 1e-5 of JAX's scatter-add, the bf16 one-hot
    within 1e-2 of the largest entry (the JAX script's bf16 precision)."""
    Kw, N, Pw = 4, 64, 128
    a = profile_scatter.inputs(Kw, N, Pw)
    kfj, ptj = jnp.asarray(a["kf"]), jnp.asarray(a["pt"])
    want_E = np.asarray(jnp.zeros((Kw, Pw, 6, 3)).at[kfj, ptj].add(jnp.asarray(a["prod_E"])))
    want_H = np.asarray(jnp.zeros((Pw, 3, 3)).at[ptj].add(jnp.asarray(a["prod_Hpp"])))
    kf, pt = torch.from_numpy(a["kf"]), torch.from_numpy(a["pt"])
    pE, pH = torch.from_numpy(a["prod_E"]), torch.from_numpy(a["prod_Hpp"])
    tight = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(profile_scatter.scatter_E(kf, pt, pE, Kw, Pw).numpy(), want_E,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(profile_scatter.scatter_Hpp(pt, pH, Pw).numpy(), want_H,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        profile_scatter.onehot_E(pt, pE, Kw, Pw, torch.float32).numpy(), want_E, **tight)
    np.testing.assert_allclose(
        profile_scatter.onehot_Hpp(pt, pH, Kw, Pw, torch.float32).numpy(), want_H, **tight)
    for got, want in ((profile_scatter.onehot_E(pt, pE, Kw, Pw), want_E),
                      (profile_scatter.onehot_Hpp(pt, pH, Kw, Pw), want_H)):
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= 1e-2 * np.abs(want).max()


def test_profile_scatter_runs_and_grouped_agrees():
    out = profile_scatter.run(Kw=4, N=64, Pw=128, reps=1, ba_reps=1, device="cpu")
    ag = out["agreement"]
    assert ag["window_poses_max_abs"] <= 1e-4 and ag["window_points_max_abs"] <= 1e-3
    assert ag["onehot_f32_E_max_abs"] <= 1e-5 and ag["onehot_bf16_Hpp_rel"] <= 1e-2
    assert set(out["bundle_adjust"]) == {"scatter_iters1", "scatter_iters2", "scatter_iters10",
                                         "grouped_iters1", "grouped_iters2", "grouped_iters8",
                                         "grouped_iters10"}


# ----------------------------------------------------------------------
# common: the trace arithmetic
# ----------------------------------------------------------------------

def test_busy_union_and_summary():
    """Overlapping and nested intervals count once; the busy share is the
    union over the wall time; ops are ranked by their own time."""
    ev = [("k1", 0, 10), ("k2", 5, 10), ("k2", 6, 2), ("Memcpy HtoD", 30, 5), ("k1", 100, 1)]
    assert common.busy_union_ns(ev) == 15 + 5 + 1
    s = common.summarize(ev, wall_s=1e-7, frames=5)
    assert s["busy_share"] == pytest.approx(0.21)
    assert s["launches_per_frame"] == 1 and s["kernels_per_frame"] == 0.8
    assert [o["name"] for o in s["top_device_ops"]] == ["k2", "k1", "Memcpy HtoD"]
    assert s["top_device_ops"][0]["calls"] == 2


def test_trace_window_on_the_cpu_reports_no_busy_share():
    with common.trace_window(CPU, 3) as tr:
        torch.ones(4) + 1
    assert tr["frames"] == 3 and tr["wall_ms"] > 0
    assert "busy_share" not in tr and "top_device_ops" not in tr
    assert common.launches(lambda: torch.ones(2), CPU) is None


def test_graph_launches_on_the_cpu_is_none():
    assert common.graph_launches(lambda: torch.ones(2), CPU) is None


# ----------------------------------------------------------------------
# the scripts' main functions at a small size
# ----------------------------------------------------------------------

def test_profile_stages_small():
    out = profile_stages.run(small_config(), n_frames=20, n_points=600, reps=1, device="cpu")
    assert out["map_kfs"] >= 2 and out["device"] == "cpu"
    assert set(out["stages"]) == {
        "tiny_roundtrip", "upload_frame", "extract_and_track", "extract_features",
        "track_frame", "update_found_visible", "process_new_keyframe",
        "local_bundle_adjustment", "covisibility_row", "bow_query", "bow_add",
        "track_reference_kf"}
    for row in out["stages"].values():
        assert row["wall_ms"] >= 0 and row["device_ms"] is None and row["launches"] is None


def test_profile_mono_small_with_trace():
    out = profile_mono.run("mono", small_config(), n_frames=20, trace=True, warmup=False,
                           window=(10, 14), device="cpu")
    assert out["frames"] == 20 and out["fps"] > 0
    assert set(out["frame_ms"]) == {"p50", "p90", "p99", "max", "mean"}
    names = [b["name"] for b in out["buckets"]]
    assert "extract_and_track_dispatch" in names and "track_decide_total" in names
    totals = [b["sum_s"] for b in out["buckets"]]
    assert totals == sorted(totals, reverse=True)
    assert {"kf_inserted", "frames_tracked", "frames_lost"} <= set(out["stats"])
    assert set(out["launches"]) >= {"fast_score_nms_levels", "hamming_best_two_projection"}
    assert out["trace_window"] == [10, 14] and out["trace"]["frames"] == 4
    assert "busy_share" not in out["trace"]      # absent on the CPU, not faked


@pytest.mark.parametrize("name", ["stereo", "mono_inertial", "collab_2agent"])
def test_profile_mono_traces_the_other_loops(name):
    """--config's loops at 6 frames (cycles), frames 2-3 traced: one pass,
    the trace window's wall time, the system's stats."""
    import dataclasses
    c = small_config()
    if name == "stereo":
        c = c.replace(camera=dataclasses.replace(c.camera, baseline=0.11))
    out = profile_mono.run(name, c, n_frames=6, window=(2, 4), device="cpu")
    assert out["config"] == name and out["frames"] == 6
    assert out["trace_window"] == [2, 4] and out["trace"]["frames"] == 2
    assert out["trace"]["wall_ms"] > 0 and "busy_share" not in out["trace"]
    assert "buckets" not in out and isinstance(out["stats"], dict)


def test_profile_ab_u8_small():
    out = profile_ab_u8.run(small_config(), n_frames=12, warmup=False, device="cpu")
    u8, f32 = out["arms"]
    assert u8["u8"] and not f32["u8"]
    for arm in (u8, f32):
        assert arm["fps"] > 0 and "frames_lost" in arm["stats"]
    assert profile_ab_u8.run(small_config(), n_frames=12, warmup=False, device="cpu",
                             u8_arm=u8)["arms"][0] is u8


def test_profile_mono_switches_the_tracer_off_after_an_exception(monkeypatch):
    """The timed pass records the port's tracer; when a frame raises inside
    it the tracer is off again and a later pass records anew."""
    import warnings

    from multi_orbslam3_tpu_torch.utils.timing import GLOBAL_TIMER

    def broken(*args, **kw):
        raise RuntimeError("frame failed")

    shown = warnings.showwarning
    monkeypatch.setattr(tracking, "extract_and_track", broken)
    with pytest.raises(RuntimeError, match="frame failed"):
        profile_mono.run("mono", small_config(), n_frames=6, warmup=False, device="cpu")
    assert not GLOBAL_TIMER.on and warnings.showwarning is shown
    assert GLOBAL_TIMER.spans and GLOBAL_TIMER.spans[-1].t1 is not None
    monkeypatch.undo()
    out = profile_mono.run("mono", small_config(), n_frames=6, warmup=False, device="cpu")
    assert not GLOBAL_TIMER.on
    assert sum(b["n"] for b in out["buckets"] if b["name"] == "extract_and_track_dispatch") \
        == sum(1 for s in GLOBAL_TIMER.spans if s.name == "step") > 0


@pytest.mark.parametrize("name", ["stages", "mono", "ab_u8", "scatter", "covis"])
def test_profilers_need_a_card_by_default(name):
    """device=None is the card: without one every profiler raises before
    it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    run = {"stages": profile_stages.run, "mono": profile_mono.run,
           "ab_u8": profile_ab_u8.run, "scatter": profile_scatter.run,
           "covis": profile_covis.run}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
