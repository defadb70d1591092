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

from multi_orbslam3_tpu_torch import config as cfg
from multi_orbslam3_tpu_torch.dataio import synthetic
from multi_orbslam3_tpu_torch.eval import ate
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


def _noise(shape, seed, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    img = torch.round(torch.rand(shape, generator=g, device=dev) * 255.0)
    img[2:12, 2:40] = 90.0          # a flat plateau
    return img


@pytest.mark.parametrize("shape", [(480, 752), (231, 363), (134, 210), (17, 33)])
def test_fast_score_nms_kernel_equals_plain(dev, shape):
    """Exact equality, on uint8-valued noise with a flat plateau."""
    img = _noise(shape, shape[0], dev)
    before = kernels.launch_counts()["fast_score_nms_levels"]
    got = kernels.fast_score_nms(img, 7.0)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fast_score_nms_levels"] == before + 1
    assert torch.equal(got, kernels.fast_score_nms_ref(img, 7.0))


PYRAMID_SHAPES = [(480, 752), (400, 627), (333, 522), (278, 435), (231, 363),
                  (193, 302), (161, 252), (134, 210)]


@pytest.mark.parametrize("shapes", [PYRAMID_SHAPES, [(17, 33), (5, 7), (64, 64)],
                                    [(40, 40)] * 16])
def test_fast_score_nms_levels_kernel_equals_plain(dev, shapes):
    """Exact equality level by level, from ONE launch: the bench camera's
    8 level shapes, small odd shapes, and a full table of 16 levels."""
    levels = [_noise(sh, i, dev) for i, sh in enumerate(shapes)]
    before = kernels.launch_counts()["fast_score_nms_levels"]
    got = kernels.fast_score_nms_levels(levels, 7.0)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fast_score_nms_levels"] == before + 1
    for g, want in zip(got, kernels.fast_score_nms_levels_ref(levels, 7.0)):
        assert torch.equal(g, want)
    assert sum(int((g > 0).sum()) for g in got) > 0


def test_fast_score_nms_levels_on_a_side_stream_and_in_a_cuda_graph(dev):
    """The level table travels as a kernel parameter, so the launch works
    on a non-default stream and can be captured in a CUDA graph: the replay
    on new pixels equals the plain version."""
    levels = [_noise(sh, i, dev) for i, sh in enumerate(PYRAMID_SHAPES[::3])]
    want = kernels.fast_score_nms_levels_ref(levels, 7.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernels.fast_score_nms_levels(levels, 7.0)
    side.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernels.fast_score_nms_levels(levels, 7.0)
    fresh = [_noise(im.shape, 100 + i, dev) for i, im in enumerate(levels)]
    for im, new in zip(levels, fresh):
        im.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    want = kernels.fast_score_nms_levels_ref(fresh, 7.0)
    assert all(torch.equal(g, w) for g, w in zip(captured, want))


def _words(rng, n, dev):
    return torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64)
                            .astype(np.int32)).to(dev)


@pytest.mark.parametrize("n,m", [(16384, 1024), (1024, 1024), (16384, 16384), (1, 1),
                                 (65, 130)])
def test_hamming_kernel_equals_plain(dev, n, m):
    """Exact equality on random int32 words (all 32 bits used)."""
    rng = np.random.RandomState(n + m)
    d1, d2 = _words(rng, n, dev), _words(rng, m, dev)
    got = kernels.hamming_matrix(d1, d2)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.hamming_matrix_ref(d1, d2))


def _match_case(n, m, dev, ties):
    """Random descriptors with about 25% of rows and columns invalid; with
    `ties`, every 7th column repeats its left neighbour, every 5th row is
    a copy of a column, and one row and one column are fully masked."""
    rng = np.random.RandomState(n * 3 + m)
    d1, d2 = _words(rng, n, dev), _words(rng, m, dev)
    v1 = torch.from_numpy(rng.rand(n) < 0.75).to(dev)
    v2 = torch.from_numpy(rng.rand(m) < 0.75).to(dev)
    if ties:
        d2[7::7] = d2[6:-1:7][: d2[7::7].shape[0]].clone()
        src = torch.from_numpy(rng.randint(0, m, n)).to(dev)
        d1[::5] = d2[src][::5]
        v1[min(3, n - 1)] = False
        v2[min(2, m - 1)] = False
    return d1, v1, d2, v2


@pytest.mark.parametrize("inner", ["popc", "mma"])
@pytest.mark.parametrize("n,m,ties", [(16384, 1024, False), (1024, 1024, True),
                                      (16384, 16384, True), (1, 1, False),
                                      (300, 77, True), (65, 130, True), (33, 7, False)])
def test_hamming_best_two_valid_kernel_equals_plain(dev, n, m, ties, inner):
    """Exact equality of idx, best, second and the column argmin, for both
    inner products; the plain version runs in row blocks at 16,384^2."""
    d1, v1, d2, v2 = _match_case(n, m, dev, ties)
    name = f"hamming_best_two_valid_{inner}"
    before = kernels.launch_counts()[name]
    got = kernels.hamming_best_two_valid(d1, v1, d2, v2, inner=inner)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    want = kernels.hamming_best_two_valid_ref(d1, v1, d2, v2, row_block=2048)
    for g, w, what in zip(got, want, ("idx", "best", "second", "argmin_row")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
    if ties and n > 100:
        assert int(((got[1] == got[2]) & (got[1] < kernels.BIG)).sum()) > 0


def _projection_case(n, m, dev):
    """Positions on a half-pixel grid (pairs exactly on the radius occur),
    duplicated features, one fully masked row and column."""
    rng = np.random.RandomState(n + 7 * m)
    d1, v1, d2, v2 = _match_case(n, m, dev, True)
    feat_uv = np.round(rng.uniform(0, 700, (m, 2)) * 2) / 2
    feat_uv[7::7] = feat_uv[6:-1:7][: len(feat_uv[7::7])]
    src = rng.randint(0, m, n)
    proj_uv = feat_uv[src] + np.round(rng.normal(0, 6, (n, 2)) * 2) / 2
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    d1 = torch.where(torch.from_numpy(rng.rand(n) < 0.5).to(dev)[:, None],
                     d2[torch.from_numpy(src).to(dev)], d1)
    return dict(mp_desc=d1, proj_uv=f32(proj_uv), proj_valid=v1,
                radius=f32(rng.choice([2.5, 5.0, 6.5, 10.0, 15.0], n)),
                pred_level=i32(rng.randint(0, 8, n)), feat_desc=d2,
                feat_uv=f32(feat_uv), feat_valid=v2,
                feat_level=i32(rng.randint(0, 8, m)))


@pytest.mark.parametrize("n,m", [(16384, 1024), (1024, 1024), (300, 77), (5, 3),
                                 (65, 130)])
@pytest.mark.parametrize("radius,level_slack", [("tensor", 1), (7.5, 2), ("tensor", 8)])
def test_hamming_best_two_projection_kernel_equals_plain(dev, n, m, radius, level_slack):
    """Exact equality of idx, best and second: the kernel's float32 radius
    test agrees with the plain version's on every pair, edge pairs
    included."""
    c = _projection_case(n, m, dev)
    if radius != "tensor":
        c["radius"] = radius
    before = kernels.launch_counts()["hamming_best_two_projection"]
    got = kernels.hamming_best_two_projection(**c, level_slack=level_slack)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["hamming_best_two_projection"] == before + 1
    want = kernels.hamming_best_two_projection_ref(**c, level_slack=level_slack)
    for g, w, what in zip(got, want, ("idx", "best", "second")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
    if n > 100:
        assert int((got[1] < kernels.BIG).sum()) > 10


def _stereo_case(n, m, dev, kind):
    """Left rows against right columns of a rectified pair. "random": each
    left feature near a right one, ~25% invalid each way. "ties": the same
    with every 7th column a copy of its neighbour and rows that copy
    columns. "tolerance": every left feature sits exactly on the row
    tolerance of its level, one float32 step beyond it, or at disparity
    exactly 0.3 / max / one step inside, against the right feature it was
    made from (positions chosen so that the differences are exact)."""
    rng = np.random.RandomState(n * 5 + m + len(kind))
    d1, v1, d2, v2 = _match_case(n, m, dev, kind != "random")
    f32 = np.float32
    src = rng.randint(0, m, n)
    levelR = rng.randint(0, 8, m).astype(np.int32)
    uvR = np.stack([np.round(rng.uniform(0, 600, m)), np.round(rng.uniform(0, 480, m))],
                   1).astype(f32)
    levelL = np.clip(levelR[src] + rng.randint(-2, 3, n), 0, 7).astype(np.int32)
    tol = (f32(2.0) * (np.float64(f32(1.2)) ** np.arange(8)).astype(f32))[levelL]
    if kind == "tolerance":
        # integer right positions below 2^10 keep uR + x and vR + x exact
        # enough that (vR + dv) - vR and (uR + disp) - uR round as planned
        # for most rows; the plain version decides the rest the same way
        step = rng.randint(0, 6, n)
        dv = np.where(step == 0, tol, np.where(step == 1, np.nextafter(tol, f32(np.inf)),
                      np.where(step == 2, -tol, f32(0.0)))).astype(f32)
        disp = np.where(step == 3, f32(0.3), np.where(
            step == 4, f32(128.0), np.where(step == 5, np.nextafter(f32(128.0), f32(0)),
                                            f32(40.0)))).astype(f32)
        uvL = np.stack([uvR[src, 0] + disp, uvR[src, 1] + dv], 1).astype(f32)
    else:
        uvL = (uvR[src] + np.stack([rng.uniform(-5, 140, n), rng.randn(n) * 3.0], 1)
               ).astype(f32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    srcd = to(src)
    d1 = torch.where(to(rng.rand(n) < 0.6)[:, None], d2[srcd], d1)
    return dict(descL=d1, uvL=to(uvL), validL=v1, levelL=to(levelL), tol=to(tol),
                descR=d2, uvR=to(uvR), validR=v2, levelR=to(levelR))


@pytest.mark.parametrize("kind", ["random", "ties", "tolerance"])
@pytest.mark.parametrize("n,m", [(1024, 1024), (300, 77), (5, 3), (65, 130), (2000, 1024)])
def test_hamming_best_two_stereo_kernel_equals_plain(dev, n, m, kind):
    """Exact equality of idx, best and second: the kernel's float32 row,
    disparity and level tests agree with the plain version's on every
    pair, pairs on the limits included; the tolerance vector equals the
    table the CPU builds."""
    c = _stereo_case(n, m, dev, kind)
    assert torch.equal(kernels.stereo_row_tolerance(c["levelL"], 2.0), c["tol"])
    before = kernels.launch_counts()["hamming_best_two_stereo"]
    got = kernels.hamming_best_two_stereo(**c, max_disparity=128.0)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["hamming_best_two_stereo"] == before + 1
    want = kernels.hamming_best_two_stereo_ref(**c, max_disparity=128.0)
    for g, w, what in zip(got, want, ("idx", "best", "second")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
    if n > 100:
        assert int((got[1] < kernels.BIG).sum()) > 10
        assert int((got[1] >= kernels.BIG).sum()) > 0


def test_stereo_match_on_the_card_equals_the_cpu(dev):
    """frontend.stereo.stereo_match launches the fused kernel for CUDA
    features and gives the CPU's result."""
    from multi_orbslam3_tpu_torch.frontend import stereo
    c = _stereo_case(1024, 1024, dev, "ties")

    def feats(side, device):
        z = torch.zeros(1024, device=device)
        uv = c["uv" + side].to(device)
        return FrameFeatures(uv=uv, uv_und=uv, response=z, level=c["level" + side].to(device),
                             angle=z, desc=c["desc" + side].to(device),
                             valid=c["valid" + side].to(device))

    before = kernels.launch_counts()["hamming_best_two_stereo"]
    got = stereo.stereo_match(feats("L", dev), feats("R", dev), 50.0)
    assert kernels.launch_counts()["hamming_best_two_stereo"] == before + 1
    want = stereo.stereo_match(feats("L", "cpu"), feats("R", "cpu"), 50.0)
    assert int(want.valid.sum()) > 10
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_fused_matches_on_a_side_stream(dev):
    """Both fused matches launched on a non-default stream."""
    d1, v1, d2, v2 = _match_case(300, 77, dev, True)
    c = _projection_case(300, 77, dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_v = [kernels.hamming_best_two_valid(d1, v1, d2, v2, inner=i)
                 for i in ("popc", "mma")]
        got_p = kernels.hamming_best_two_projection(**c, level_slack=1)
    side.synchronize()
    want_v = kernels.hamming_best_two_valid_ref(d1, v1, d2, v2)
    for got in got_v:
        assert all(torch.equal(g, w) for g, w in zip(got, want_v))
    want_p = kernels.hamming_best_two_projection_ref(**c, level_slack=1)
    assert all(torch.equal(g, w) for g, w in zip(got_p, want_p))


def test_kernels_reject_what_they_do_not_take(dev):
    with pytest.raises(ValueError):
        kernels.fast_score_nms(torch.zeros((8, 8), device=dev, dtype=torch.float64), 7.0)
    with pytest.raises(ValueError):
        kernels.fast_score_nms_levels([torch.zeros((8, 8), device=dev)] * 17, 7.0)
    with pytest.raises(ValueError):
        kernels.hamming_matrix(torch.zeros((4, 8), device=dev, dtype=torch.int32),
                               torch.zeros((4, 4), device=dev, dtype=torch.int32))
    d = torch.zeros((4, 8), device=dev, dtype=torch.int32)
    v = torch.ones(4, device=dev, dtype=torch.bool)
    with pytest.raises(ValueError):
        kernels.hamming_best_two_valid(d, v.to(torch.uint8), d, v)
    with pytest.raises(ValueError):
        kernels.hamming_best_two_valid(d, v, d, v, inner="wgmma")


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


def test_monoslam_without_a_device_runs_on_the_card(dev):
    assert MonoSlam(cfg.small_synthetic()).device.type == "cuda"


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
    assert counts["fast_score_nms_levels"] > 0, counts
    assert counts["hamming_best_two_valid_popc"] + counts["hamming_best_two_valid_mma"] > 0, counts
    assert counts["hamming_best_two_projection"] > 0, counts
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


@pytest.mark.parametrize("keep,inner", [(0.04, "popc"), (0.04, "mma"), (0.75, "popc"),
                                        (0.75, "mma")])
def test_validity_match_at_the_collab_arena_shape(dev, keep, inner):
    """32768 x 32768, the collaborative server's map x map cascade (two
    agents of 16384 landmarks), about 4% and 75% valid: exact."""
    n = 32768
    g = torch.Generator(device=dev)
    g.manual_seed(int(keep * 100))
    words = lambda: torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 8), generator=g, device=dev,
                                  dtype=torch.int64).to(torch.int32)
    d1, d2 = words(), words()
    v1 = torch.rand(n, generator=g, device=dev) < keep
    v2 = torch.rand(n, generator=g, device=dev) < keep
    got = kernels.hamming_best_two_valid(d1, v1, d2, v2, inner=inner)
    torch.cuda.synchronize()
    want = kernels.hamming_best_two_valid_ref(d1, v1, d2, v2, row_block=2048)
    for gg, w, what in zip(got, want, ("idx", "best", "second", "argmin_row")):
        assert gg.dtype == w.dtype and torch.equal(gg, w), what


def test_projection_match_at_the_collab_arena_shape(dev):
    """32768 x 1024, the server's arena fuse (fuse_into_keyframe on the
    arena): exact."""
    c = dict(_projection_case(32768, 1024, dev), level_slack=1)
    got = kernels.hamming_best_two_projection(**c)
    torch.cuda.synchronize()
    want = kernels.hamming_best_two_projection_ref(**c)
    for gg, w, what in zip(got, want, ("idx", "best", "second")):
        assert gg.dtype == w.dtype and torch.equal(gg, w), what
    assert int((got[1] < kernels.BIG).sum()) > 0


def _gba_problem(d, n_kf=24, n_mp=800, n_feat=64, seed=0):
    """Keyframes along x, landmarks ahead of them, noisy projections and
    noisy landmark positions; the first keyframe fixed."""
    from multi_orbslam3_tpu_torch.geometry import camera as cam
    from multi_orbslam3_tpu_torch.opt.local_ba import BAObservations
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-6, 2, n_mp), rng.uniform(-2, 2, n_mp),
                    rng.uniform(4, 10, n_mp)], 1).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    poses[:, 0, 3] = 0.15 * np.arange(n_kf)
    kf = np.repeat(np.arange(n_kf), n_feat)
    pt = np.concatenate([rng.choice(n_mp, n_feat, replace=False) for _ in range(n_kf)])
    p_c = pts[pt] + poses[kf, :3, 3]
    uv = np.stack([300 * p_c[:, 0] / p_c[:, 2] + 320, 300 * p_c[:, 1] / p_c[:, 2] + 240], 1)
    uv += rng.randn(*uv.shape) * 0.5
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(d, dt)  # noqa: E731
    obs = BAObservations(kf=t(kf, torch.int32), pt=t(pt, torch.int32), uv=t(uv),
                         inv_sigma2=torch.ones(len(kf), device=d),
                         valid=t(rng.rand(len(kf)) < 0.9, torch.bool))
    K = cam.PinholeK(*(torch.tensor(v, device=d) for v in (300.0, 300.0, 320.0, 240.0)))
    fixed = torch.zeros(n_kf, dtype=torch.bool, device=d)
    fixed[0] = True
    noisy = pts + rng.randn(n_mp, 3).astype(np.float32) * 0.05
    return t(poses), fixed, t(noisy), torch.ones(n_mp, dtype=torch.bool, device=d), obs, K


def test_global_bundle_adjust_on_the_card_matches_the_cpu(dev):
    """Two GN steps of 20 CG iterations on the card against the CPU: the
    card's index_add order differs, so within 1e-3."""
    from multi_orbslam3_tpu_torch.opt import global_ba
    out = []
    for d in (dev, torch.device("cpu")):
        r = global_ba.global_bundle_adjust(*_gba_problem(d), iters=2, cg_iters=20)
        out.append([x.cpu().numpy() for x in (r.poses, r.points, r.chi2, r.chi2_in)])
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-3)
    assert out[0][2] < out[0][3]


def test_collab_entry_points_run_on_the_card(dev):
    """CollabClient and CollabServer without a device argument live on the
    card (without one they raise: tests/test_torch_no_jax.py)."""
    from multi_orbslam3_tpu_torch.collab import (CollabClient, CollabServer,
                                                 InProcessTransport)
    c = cfg.small_synthetic()
    tr = InProcessTransport()
    assert CollabClient(c, 0, tr).slam.m.kf_pose.device.type == "cuda"
    server = CollabServer(c, tr, 2)
    assert server.m.kf_pose.device.type == "cuda" and server.db.word.device.type == "cuda"


def test_sharded_global_bundle_adjust_on_the_card_matches_the_cpu(dev):
    """Four shards of the card against the unsharded solve on the CPU."""
    from multi_orbslam3_tpu_torch.opt import global_ba
    r4 = global_ba.global_bundle_adjust_sharded(*_gba_problem(dev), iters=2, cg_iters=20,
                                                devices=[dev] * 4)
    ru = global_ba.global_bundle_adjust(*_gba_problem(torch.device("cpu")), iters=2,
                                        cg_iters=20)
    for a, b in zip((r4.poses, r4.points, r4.chi2), (ru.poses, ru.points, ru.chi2)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-3, rtol=1e-3)


def test_inertial_collab_entry_points_run_on_the_card(dev):
    """CollabClient(inertial=True) and the sharded server entry on the card."""
    from multi_orbslam3_tpu_torch.collab import CollabClient, InProcessTransport
    from multi_orbslam3_tpu_torch.dryrun import dryrun_multichip
    cl = CollabClient(cfg.small_synthetic(), 0, InProcessTransport(), inertial=True)
    assert type(cl.slam).__name__ == "MonoInertialSlam"
    assert cl.slam.m.kf_pose.device.type == "cuda"
    out = dryrun_multichip([dev] * 4)
    assert out["chi2_after"] <= 1.01 * out["chi2_before"]


def test_sharded_global_bundle_adjust_across_cards(dev, monkeypatch):
    """One shard on each visible card, the partials summed by
    torch.cuda.comm.reduce_add, against as many shards on one card; then
    the dry run across the cards."""
    import torch.cuda.comm
    from multi_orbslam3_tpu_torch.dryrun import dryrun_multichip
    from multi_orbslam3_tpu_torch.opt import global_ba
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA GPUs")
    cards = [torch.device("cuda", i) for i in range(n)]
    calls = []
    reduce_add = torch.cuda.comm.reduce_add
    monkeypatch.setattr(torch.cuda.comm, "reduce_add",
                        lambda *a, **k: calls.append(1) or reduce_add(*a, **k))
    rn = global_ba.global_bundle_adjust_sharded(*_gba_problem(cards[0]), iters=2,
                                                cg_iters=20, devices=cards)
    assert calls
    r1 = global_ba.global_bundle_adjust_sharded(*_gba_problem(cards[0]), iters=2,
                                                cg_iters=20, devices=[cards[0]] * n)
    for a, b in zip((rn.poses, rn.points, rn.chi2), (r1.poses, r1.points, r1.chi2)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=1e-3, rtol=1e-3)
    out = dryrun_multichip(cards)
    assert out["chi2_after"] <= 1.01 * out["chi2_before"]


def test_bench_kernels_dispatches_the_kernels_and_they_equal_the_plain_versions(dev):
    """eval/benchmarks.py::bench_kernels at the JAX package's shapes (K1 on
    one 480x752 level of noise, K2's matrix at 16,384 x 1,024): the card
    path launches both kernels, and both equal their plain versions."""
    from multi_orbslam3_tpu_torch.eval import benchmarks as B
    kernels.reset_launch_counts()
    out = B.bench_kernels(device=dev)
    counts = kernels.launch_counts()
    assert out["dispatched"] == "cuda" and out["fast_equal"] and out["hamming_equal"], out
    assert counts["fast_score_nms_levels"] > 0 and counts["hamming_matrix"] > 0, counts
    assert out["codec"]["native_available"]
