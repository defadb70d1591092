"""The hand-written CUDA kernels against their plain PyTorch versions, on
the GPU. Every test here needs an NVIDIA sm_90a card and nvcc; without a
card they skip. Run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(``--noconftest``: tests/conftest.py sets up JAX, which a GPU machine
need not have; this file imports no JAX.)
"""

import numpy as np
import pytest
import torch

from multi_orbslam3_tpu import config as cfg
from multi_orbslam3_tpu.dataio import synthetic
from multi_orbslam3_tpu.eval import ate
from multi_orbslam3_tpu_torch.frontend import kernels
from multi_orbslam3_tpu_torch.frontend.extractor import FrameFeatures
from multi_orbslam3_tpu_torch.geometry import se3, sim3
from multi_orbslam3_tpu_torch.map import mapstate as ms
from multi_orbslam3_tpu_torch.opt import pose_graph
from multi_orbslam3_tpu_torch.pipeline import initializer, loop_closing
from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam, TrackState

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU form)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(480, 752), (231, 363), (134, 210), (17, 33)])
def test_fast_score_nms_kernel_equals_plain(dev, shape):
    """Exact equality, on uint8-valued noise with a flat plateau."""
    g = torch.Generator(device=dev)
    g.manual_seed(shape[0])
    img = torch.round(torch.rand(shape, generator=g, device=dev) * 255.0)
    img[2:12, 2:40] = 90.0
    before = kernels.fast_score_nms.launches
    got = kernels.fast_score_nms(img, 7.0)
    torch.cuda.synchronize()
    assert kernels.fast_score_nms.launches == before + 1
    assert torch.equal(got, kernels.fast_score_nms_ref(img, 7.0))


@pytest.mark.parametrize("n,m", [(16384, 1024), (1024, 1024), (16384, 16384), (1, 1),
                                 (65, 130)])
def test_hamming_kernel_equals_plain(dev, n, m):
    """Exact equality on random int32 words (all 32 bits used)."""
    rng = np.random.RandomState(n + m)
    d1 = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64)
                          .astype(np.int32)).to(dev)
    d2 = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (m, 8), dtype=np.int64)
                          .astype(np.int32)).to(dev)
    got = kernels.hamming_matrix(d1, d2)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.hamming_matrix_ref(d1, d2))


def test_kernels_reject_what_they_do_not_take(dev):
    with pytest.raises(ValueError):
        kernels.fast_score_nms(torch.zeros((8, 8), device=dev, dtype=torch.float64), 7.0)
    with pytest.raises(ValueError):
        kernels.hamming_matrix(torch.zeros((4, 8), device=dev, dtype=torch.int32),
                               torch.zeros((4, 4), device=dev, dtype=torch.int32))


def _run_small_sequence(device):
    c = cfg.small_synthetic()
    seq = synthetic.make_sequence(c, n_frames=40, n_points=500, seed=7,
                                  trajectory="forward")
    slam = MonoSlam(c, device=device)
    for i in range(seq.images.shape[0]):
        slam.process_frame_pipelined(seq.images[i], float(seq.timestamps[i]))
    slam.finish()
    states = [s for _, s in slam.frame_log]
    n0 = states.index(TrackState.OK)
    est = np.stack([T for _, T in slam.trajectory])
    e, g = ate.camera_centers(est[n0:]), ate.camera_centers(seq.T_cw[n0:])
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    return slam, states.count(TrackState.OK), ate.ate_rmse(e, g) / span


def test_monoslam_on_the_card_tracks_like_the_cpu(dev, monkeypatch):
    """The small synthetic sequence through MonoSlam with all state on the
    GPU, then on the CPU. A CUDA generator draws other numbers than a CPU
    one from the same seed, and on this sequence about one seed in five
    gives a weak two-view map in both packages; so the initializer's RANSAC
    samples are drawn on the CPU here and both runs start from the same
    hypotheses. Required: both kernels launched on the GPU run, the CPU
    end-to-end gates (final state OK, >= 3 keyframes, > 25 of 40 frames
    tracked, ATE < 0.05 x span), and frames OK within 3 of the CPU run."""
    sample = initializer.sample_hypotheses

    def sample_on_cpu(match_valid, n_hyp, k, generator):
        g = torch.Generator().manual_seed(generator.initial_seed())
        return sample(match_valid.cpu(), n_hyp, k, g).to(match_valid.device)

    monkeypatch.setattr(initializer, "sample_hypotheses", sample_on_cpu)
    kernels.reset_launch_counts()
    slam, n_ok, ate_rel = _run_small_sequence(dev)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["fast_score_nms"] > 0 and counts["hamming_matrix"] > 0, counts
    assert slam.state == TrackState.OK
    assert slam.stats["kf_inserted"] >= 3
    assert slam.stats["frames_tracked"] > 25
    assert ate_rel < 0.05
    _, n_ok_cpu, _ = _run_small_sequence("cpu")
    assert abs(n_ok - n_ok_cpu) <= 3


def _loop_map(device):
    """tests/test_loop.py's arc of 12 keyframes with 20 landmarks each,
    keyframes 6-11 and their landmarks drifted by a Sim3, built with the
    port's own functions; returns (map, drift)."""
    rng = np.random.RandomState(0)
    n_feat = 32
    m = ms.empty_map(16, 512, n_feat, device)
    S_d = sim3.exp(torch.tensor([0.0, 0.05, 0.0, 0.3, 0.0, 0.1, 0.08], device=device))
    for i in range(12):
        T = se3.exp(torch.tensor([0.0, 0.25 * i, 0.0, 0.6 * i, 0.0, 0.0], device=device))
        pts = torch.from_numpy(rng.uniform(-1, 1, (20, 3)).astype(np.float32)).to(device)
        p_w = se3.apply(se3.inverse(T)[None], pts + torch.tensor([0.0, 0.0, 4.0], device=device))
        if i >= 6:
            T = sim3.to_se3_scaled(sim3.compose(sim3.from_se3(T), sim3.inverse(S_d)))
            p_w = sim3.apply(S_d, p_w)
        desc = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (n_feat, 8), dtype=np.int64)
                                .astype(np.int32)).to(device)
        f = FrameFeatures(uv=torch.zeros(n_feat, 2, device=device),
                          uv_und=torch.zeros(n_feat, 2, device=device),
                          response=torch.ones(n_feat, device=device),
                          level=torch.zeros(n_feat, dtype=torch.int32, device=device),
                          angle=torch.zeros(n_feat, device=device), desc=desc,
                          valid=torch.ones(n_feat, dtype=torch.bool, device=device))
        m, k = ms.add_keyframe(m, f, T, float(i),
                               torch.full((n_feat,), -1, dtype=torch.int32, device=device), i - 1)
        idx = torch.arange(20, device=device)
        m, _ = ms.add_mappoints(m, p_w, torch.ones(20, dtype=torch.bool, device=device),
                                desc[:20], k, k, idx, k, idx)
    return m, S_d


def test_optimize_pose_graph_on_the_card_matches_the_cpu(dev):
    """The essential graph of the drifted arc (tree + covisibility + loop
    edge), dense and CG, on the card against the same call on the CPU:
    within 1e-3."""
    for solver in ("dense", "cg"):
        out = []
        for d in (dev, torch.device("cpu")):
            m, _ = _loop_map(d)
            S = sim3.stack(sim3.from_se3(m.kf_pose))
            i = torch.arange(1, 12, device=d)
            edges = pose_graph.make_edges(S, torch.cat([i, torch.tensor([11], device=d)]),
                                          torch.cat([i - 1, torch.tensor([0], device=d)]),
                                          torch.ones(12, device=d),
                                          torch.ones(12, dtype=torch.bool, device=d))
            edges = edges._replace(S_ij=torch.cat([edges.S_ij[:-1], sim3.stack(
                sim3.identity(device=d))[None]]))
            fixed = torch.arange(16, device=d) >= 12
            fixed[0] = True
            out.append(pose_graph.optimize_pose_graph(S, fixed, edges, iters=8,
                                                      solver=solver).cpu())
        np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), atol=1e-3)


def test_correct_loop_on_the_card_matches_the_cpu(dev):
    """correct_loop on the drifted arc, closed by the true drift: keyframe
    poses and landmark positions on the card within 1e-3 of the CPU's."""
    got = []
    for d in (dev, torch.device("cpu")):
        m, S_d = _loop_map(d)
        m2 = loop_closing.correct_loop(m, 11, 0, S_d, max_covis_edges=32, iters=12)
        got.append((m2.kf_pose.cpu().numpy(), m2.mp_pos.cpu().numpy()))
    np.testing.assert_allclose(got[0][0], got[1][0], atol=1e-3)
    np.testing.assert_allclose(got[0][1], got[1][1], atol=1e-3)
