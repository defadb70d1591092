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
from multi_orbslam3_tpu_torch.pipeline import initializer
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


@pytest.mark.parametrize("n,m", [(16384, 1024), (1024, 1024), (1, 1), (65, 130)])
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
