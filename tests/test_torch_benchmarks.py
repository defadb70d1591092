"""The port's benchmarks (eval/benchmarks.py) against the JAX package's on
the CPU: the configurations and the ATE protocol equal, the vocabulary
selectivity study at a small size (equal recall, margins within 1e-3
relative), the global-BA studies counting the same observations on the
same arenas, the codec study reporting the same keys; and, slow like
their JAX twins in tests/test_euroc_drill.py, the EuRoC drill end to end
and the mono-inertial pipeline fed from an ASL tree with epoch stamps."""

import dataclasses

import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.eval import benchmarks as JB
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch.eval import benchmarks as TB

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [{}, {"baseline": 0.11}])
def test_the_bench_config_equals_the_jax_packages(kw):
    assert dataclasses.asdict(TB._euroc_scale_config(**kw)) == \
        dataclasses.asdict(JB._euroc_scale_config(**kw))
    assert TB.EUROC_T_BC == JB.EUROC_T_BC


@pytest.mark.parametrize("with_scale,skip_head", [(True, 0), (False, 0), (True, 7)])
def test_ate_over_ok_equals_the_jax_packages(with_scale, skip_head):
    """Same trajectory, same states (each package's own TrackState), same
    report; fewer than 10 OK frames give None in both."""
    from multi_orbslam3_tpu.pipeline.system import TrackState as JS
    from multi_orbslam3_tpu_torch.pipeline.system import TrackState as TS
    rng = np.random.RandomState(5)
    n = 30
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.randn(n, 3) * 0.1, 0)
    est = gt.copy()
    est[:, :3, 3] = est[:, :3, 3] * 1.7 + rng.randn(n, 3) * 0.01
    traj = [(0.05 * i, est[i]) for i in range(n)]
    ok = rng.rand(n) > 0.3
    for good in (ok, np.arange(n) < 9):
        out_j = JB._ate_over_ok(traj, [JS.OK if g else JS.LOST for g in good], gt,
                                with_scale=with_scale, skip_head=skip_head)
        out_t = TB._ate_over_ok(traj, [TS.OK if g else TS.LOST for g in good], gt,
                                with_scale=with_scale, skip_head=skip_head)
        assert out_t == out_j


def test_vocab_selectivity_matches_the_jax_package():
    """4 worlds x 6 frames (12 stored keyframes, 12 queries) through both
    packages' extraction, vocabularies and databases: the same top-1
    recall for both vocabularies, margins within 1e-3 relative."""
    kw = dict(n_worlds=4, n_frames=6)
    out_j = JB.bench_vocab_selectivity(**kw)
    out_t = TB.bench_vocab_selectivity(device="cpu", **kw)
    assert out_t["db_size"] == out_j["db_size"] == 12
    for name in ("L4_10k", "L5_100k"):
        assert out_t[name]["top1_recall"] == out_j[name]["top1_recall"], (out_t, out_j)
        np.testing.assert_allclose(out_t[name]["margin"], out_j[name]["margin"], rtol=1e-3)


@pytest.fixture(scope="module")
def arenas():
    """eval/gba_scaling.make_server_arena of both packages: the same numpy
    draws, so the same arena (tests/test_torch_gba_sharded.py)."""
    from multi_orbslam3_tpu.eval.gba_scaling import make_server_arena as jmake
    from multi_orbslam3_tpu_torch.eval.gba_scaling import make_server_arena as tmake
    kw = dict(n_kf=8, n_mp=256, n_feat=32)
    return jmake(**kw), tmake(device="cpu", **kw)


def test_bench_gba_counts_the_same_observations(arenas):
    """Every landmark of the arena is valid, so the port's assembly, which
    also masks rows of invalid landmarks, keeps the JAX bench's rows."""
    js, ts = arenas
    out_j = JB.bench_gba(js, iters=4)
    out_t = TB.bench_gba(ts, iters=4)
    assert out_t.keys() == out_j.keys()
    assert out_t["n_obs"] == out_j["n_obs"] > 0 and out_t["cg_iters"] == out_j["cg_iters"]
    assert out_t["gba_iters_per_s"] > 0


def test_bench_gba_masks_rows_of_invalid_landmarks(arenas):
    """An arena row that names an invalidated landmark is left out of the
    port's solve (the JAX bench counts it; ROADMAP queue C)."""
    _, ts = arenas
    n_all = TB.bench_gba(ts, iters=2)["n_obs"]
    m0 = ts.m
    kf_mp = m0.kf_mp[m0.kf_feat_valid & (m0.kf_mp >= 0)]
    dead = int(kf_mp[0])
    ts.m = m0._replace(mp_valid=m0.mp_valid.clone().index_fill_(0, torch.tensor([dead]), False))
    try:
        n_masked = TB.bench_gba(ts, iters=2)["n_obs"]
    finally:
        ts.m = m0
    assert n_masked == n_all - int((kf_mp == dead).sum()) < n_all


def test_bench_gba_large_on_a_small_arena_matches_the_jax_package():
    kw = dict(n_kf=8, n_mp=256, n_feat=32, iters=1, cg_iters=3)
    out_j = JB.bench_gba_large(**kw)
    out_t = TB.bench_gba_large(device="cpu", **kw)
    assert out_t["n_obs"] == out_j["n_obs"] > 0
    assert (out_t["n_kf"], out_t["n_mp"]) == (8, 256)
    assert out_t["finite"] and out_t["gba_runs"] == 2 and out_t["gba_rejected"] == 0
    assert "peak_bytes_in_use" not in out_t            # a device number, not taken on the CPU


def test_bench_codec_reports_the_same_keys():
    out_j = JB._bench_codec(np.random.RandomState(0))
    out_t = TB._bench_codec(np.random.RandomState(0))
    assert out_t.keys() == out_j.keys()
    assert out_t["native_available"] and out_t["frame_mb"] == out_j["frame_mb"]


def _write_dataset(tmp_path, imu=False, n_frames=36):
    """tests/test_euroc_drill.py::_write_dataset with the port's modules."""
    from multi_orbslam3_tpu_torch.dataio import mini_asl, synthetic
    c = tcfg.synthetic_mono(width=320, height=240)
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=700, seed=13,
                                  trajectory="forward", imu=imu,
                                  lateral=0.8 if imu else 0.4,
                                  sway_freq=0.15 if imu else 0.08)
    root = str(tmp_path / "MINI01")
    mini_asl.write_mini_asl(root, seq)
    return c, seq, root


@pytest.mark.slow
def test_bench_euroc_end_to_end(tmp_path, monkeypatch):
    """test_euroc_drill.py::test_bench_euroc_end_to_end on the port: the
    same 320x240, 36-frame tree through bench_euroc; a sane ATE from the
    ground-truth csv."""
    c, seq, root = _write_dataset(tmp_path, n_frames=36)
    monkeypatch.setattr(TB, "_euroc_scale_config",
                        lambda **kw: tcfg.synthetic_mono(width=320, height=240))
    out = TB.bench_euroc(root, n_frames=36, device="cpu")
    assert out is not None and out["frames"] == 36
    assert "ate_rmse" in out, out
    g = np.stack([-T[:3, :3].T @ T[:3, 3] for T in seq.T_cw])
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    assert out["ate_rmse"] < 0.12 * max(span, 1.0), out


@pytest.mark.slow
def test_mono_inertial_epoch_timestamps(tmp_path):
    """test_euroc_drill.py::test_mono_inertial_epoch_timestamps on the port:
    MonoInertialSlam fed from an ASL tree with epoch nanosecond stamps
    initialises, and its bootstrap preintegration windows span the
    keyframe gaps (relative time, not float32 epoch seconds)."""
    from multi_orbslam3_tpu_torch.dataio import euroc
    from multi_orbslam3_tpu_torch.pipeline.inertial_system import MonoInertialSlam
    c, seq, root = _write_dataset(tmp_path, imu=True, n_frames=60)
    c = c.replace(
        orb=tcfg.ORBConfig(n_features=256, n_levels=4),
        map=tcfg.MapConfig(max_keyframes=64, max_mappoints=2048,
                           max_obs=16384, max_obs_per_kf=256),
        local_mapping=tcfg.LocalMappingConfig(
            local_ba_kfs=8, local_ba_fixed_kfs=4, local_ba_points=1024,
            local_ba_iters=8))
    slam = MonoInertialSlam(c, enable_loop_closing=False, device="cpu")
    n = 0
    for t, img, acc, gyro, dt in euroc.EurocSequence(root, imu=True):
        slam.process_frame_imu(img, t, acc, gyro, dt)
        n += 1
    assert n == 60
    own = [k for k in range(int(slam.m.n_kf)) if slam.kf_preint[k]]
    assert own, "no preintegration windows attached"
    dts = [float(slam.kf_preint[k].dT) for k in own]
    assert all(0.0 < d < 2.0 for d in dts), dts
    assert slam.imu_initialized, slam.stats

