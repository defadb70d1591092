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


@pytest.mark.parametrize("shapes", [[(40, 40)] * 17, PYRAMID_SHAPES + PYRAMID_SHAPES[:1]
                                    + PYRAMID_SHAPES + PYRAMID_SHAPES[:1],
                                    [(17 + k, 33 + 2 * k) for k in range(24)]])
def test_fast_score_nms_levels_above_one_launch_equals_plain(dev, shapes):
    """More levels than one launch takes: 17 levels, the 18 levels of a
    9-level stereo pair at the bench camera's shapes (two launches of 9)
    and 24 levels; exact level by level, one launch a group of
    kernels.even_groups, the results views of one buffer."""
    levels = [_noise(sh, i, dev) for i, sh in enumerate(shapes)]
    groups = kernels.even_groups(len(levels), kernels.MAX_LEVELS)
    assert len(groups) == 2
    before = kernels.launch_counts()["fast_score_nms_levels"]
    got = kernels.fast_score_nms_levels(levels, 7.0)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fast_score_nms_levels"] == before + len(groups)
    for g, want in zip(got, kernels.fast_score_nms_levels_ref(levels, 7.0)):
        assert torch.equal(g, want)
    assert len({g.untyped_storage().data_ptr() for g in got}) == 1
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


@pytest.mark.parametrize("n,m", [(16384, 1024), (1024, 1024), (129, 4), (300, 260),
                                 (257, 131), (3, 1029), (128, 128)])
def test_hamming_matrix_tensor_core_writer_equals_plain(dev, n, m):
    """The persistent 128 x 128-tile writer: one launch, exact, on full
    tiles, ragged edges in both directions, m not a multiple of 4 (4-byte
    stores) and inputs whose rows are not 16-byte aligned (copied)."""
    rng = np.random.RandomState(3 * n + m)
    d1, d2 = _words(rng, n, dev), _words(rng, m, dev)
    k = min(n, d2[::3].shape[0])
    d2[::3][:k] = d1[:k]                             # distance 0 on some pairs
    flat = torch.zeros(8 * n + 1, dtype=torch.int32, device=dev)
    flat[1:].copy_(d1.reshape(-1))
    shifted = flat[1:].view(n, 8)                    # 4 bytes past an alignment
    for a in (d1, shifted):
        before = kernels.launch_counts()["hamming_matrix"]
        got = kernels.hamming_matrix(a, d2)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["hamming_matrix"] == before + 1
        assert torch.equal(got, kernels.hamming_matrix_ref(d1, d2))


def test_hamming_matrix_on_a_side_stream_and_in_a_cuda_graph(dev):
    """The matrix writer on a non-default stream, and captured in a CUDA
    graph and replayed on new descriptors."""
    rng = np.random.RandomState(21)
    d1, d2 = _words(rng, 1000, dev), _words(rng, 600, dev)
    kernels.hamming_matrix(d1, d2)                   # per-device set-up before capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernels.hamming_matrix(d1, d2)
    side.synchronize()
    assert torch.equal(got, kernels.hamming_matrix_ref(d1, d2))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernels.hamming_matrix(d1, d2)
    d1.copy_(_words(rng, 1000, dev))
    d2.copy_(_words(rng, 600, dev))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, kernels.hamming_matrix_ref(d1, d2))


def _match_case(n, m, dev, ties, keep=0.75):
    """Random descriptors with about 25% of rows and columns invalid (a
    share `keep` valid); with `ties`, every 7th column repeats its left
    neighbour, every 5th row is a copy of a column, and one row and one
    column are fully masked."""
    rng = np.random.RandomState(n * 3 + m)
    d1, d2 = _words(rng, n, dev), _words(rng, m, dev)
    v1 = torch.from_numpy(rng.rand(n) < keep).to(dev)
    v2 = torch.from_numpy(rng.rand(m) < keep).to(dev)
    if ties:
        d2[7::7] = d2[6:-1:7][: d2[7::7].shape[0]].clone()
        src = torch.from_numpy(rng.randint(0, m, n)).to(dev)
        d1[::5] = d2[src][::5]
        v1[min(3, n - 1)] = False
        v2[min(2, m - 1)] = False
    return d1, v1, d2, v2


@pytest.mark.parametrize("keep", [0.75, 0.04])
@pytest.mark.parametrize("n,m,ties", [(16384, 1024, False), (1024, 1024, True),
                                      (16384, 16384, True), (1, 1, False),
                                      (300, 77, True), (65, 130, True), (33, 7, False)])
def test_hamming_best_two_valid_kernel_equals_plain(dev, n, m, ties, keep):
    """Exact equality of idx, best, second and the column argmin of the
    compacted tensor-core search, with 75% and 4% of rows and columns
    valid (the loop closer's map x map masks); the plain version runs in
    row blocks at 16,384^2."""
    d1, v1, d2, v2 = _match_case(n, m, dev, ties, keep)
    name = "hamming_best_two_valid"
    before = kernels.launch_counts()[name]
    got = kernels.hamming_best_two_valid(d1, v1, d2, v2)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    want = kernels.hamming_best_two_valid_ref(d1, v1, d2, v2, row_block=2048)
    for g, w, what in zip(got, want, ("idx", "best", "second", "argmin_row")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
    if ties and n > 100 and keep > 0.5:
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


def _stereo_band_case(n, m, dev, kind):
    """_stereo_case's "ties" inputs reshaped for the row-band search.
    "reversed_ties": five right columns with one descriptor on one image
    row, in the bucket the highest column first, and rows that copy it;
    "empty_band": left rows whose band holds no right feature and rows at
    image rows 0 and 479, one of them a pair that passes the row test only
    through rounding, from one row below the band's exact edge; "overflow": right features at |v| >= 2^20, inf and
    NaN, left rows at NaN and far out, and rows spread over more image rows
    than the index holds."""
    c = _stereo_case(n, m, dev, "ties")
    uvL, uvR = c["uvL"].clone(), c["uvR"].clone()
    if kind == "reversed_ties":
        dup = torch.tensor([10, 30, 31, 55, m - 1], device=dev)
        c["descR"][dup] = c["descR"][10].clone()
        uvR[dup] = torch.stack([100.0 + torch.arange(5, device=dev, dtype=torch.float32),
                                torch.full((5,), 200.0, device=dev)], 1)
        c["levelR"][dup] = 3
        c["validR"][dup] = True
        rows = torch.arange(0, n, 6, device=dev)
        c["descL"][rows] = c["descR"][10]
        uvL[rows] = torch.tensor([180.0, 200.5], device=dev)
        c["levelL"][rows] = 3
        c["validL"][rows] = True
    elif kind == "empty_band":
        uvR[:8, 1] = 0.0
        uvR[8:16, 1] = 479.0
        uvL[:16] = uvR[:16] + torch.tensor([20.0, 0.0], device=dev)
        c["descL"][:16] = c["descR"][:16]
        c["levelL"][:16] = c["levelR"][:16]
        c["validL"][:16] = True
        c["validR"][:16] = True
        uvR[(uvR[:, 1] - 400.5).abs() < 12, 1] = 10.0
        uvL[40:80, 1] = 400.5
        uvR[0, 1] = -1e-8                            # passes only through rounding,
        uvL[0, 1] = kernels.stereo_row_tolerance(c["levelL"][:1], 2.0)[0]   # a row below
    elif kind == "overflow":
        uvR[:, 1] = uvR[:, 1] * 12.0                 # over 5,000 image rows
        uvL[:, 1] = uvL[:, 1] * 12.0
        uvR[:6, 1] = torch.tensor([2.0 ** 20, -2.0 ** 21, float("inf"), -float("inf"),
                                   float("nan"), 5.0e6], device=dev)
        c["validR"][:6] = True
        uvL[:6] = uvR[:6] + torch.tensor([20.0, 0.0], device=dev)
        uvL[6, 1] = float("nan")
        uvL[7, 1] = 2.0 ** 21
        c["descL"][:6] = c["descR"][:6]
    c["uvL"], c["uvR"] = uvL.contiguous(), uvR.contiguous()
    c["tol"] = kernels.stereo_row_tolerance(c["levelL"], 2.0)
    return c


@pytest.mark.parametrize("kind", ["reversed_ties", "empty_band", "overflow"])
@pytest.mark.parametrize("n,m", [(1024, 1024), (300, 77), (2000, 4096)])
def test_hamming_best_two_stereo_band_search_equals_plain(dev, n, m, kind):
    """The row-band search on the cases its index makes hard: ties that
    reach a row out of column order, empty bands and rows at the image's
    edges, columns in the overflow bucket; up to 4,096 right features (a
    KITTI-size frame, the kernel's capacity). Exact against the plain
    version and the banded CPU model."""
    c = _stereo_band_case(n, m, dev, kind)
    before = kernels.launch_counts()["hamming_best_two_stereo"]
    got = kernels.hamming_best_two_stereo(**c, max_disparity=128.0)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["hamming_best_two_stereo"] == before + 1
    want = kernels.hamming_best_two_stereo_ref(**c, max_disparity=128.0)
    model = kernels.hamming_best_two_stereo_banded_ref(
        **{k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in c.items()},
        max_disparity=128.0)
    for g, w, b, what in zip(got, want, model, ("idx", "best", "second")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
        assert torch.equal(g.cpu(), b), what
    if kind == "reversed_ties":
        rows = torch.arange(0, n, 6, device=dev)
        assert (got[0][rows] == 10).all() and (got[1][rows] == 0).all()
        assert (got[2][rows] == 0).all()
    if kind == "empty_band":
        assert (got[1][:16] == 0).all() and (got[1][40:80] == kernels.BIG).all()


@pytest.mark.parametrize("kind", ["random", "tolerance", "reversed_ties", "empty_band"])
@pytest.mark.parametrize("m", [4096, 4097, 8192, 12288])
def test_hamming_best_two_stereo_in_column_chunks_equals_plain(dev, m, kind):
    """More right features than one launch's index holds: one launch a
    chunk of kernels.stereo_chunks, each seeded with the rows' results so
    far (4,096 stays one launch); exact against the plain version and the
    banded CPU model on random pairs, pairs on the limits, ties out of
    column order (the last tied column in the last chunk) and empty
    bands."""
    n = 1024
    c = (_stereo_case(n, m, dev, kind) if kind in ("random", "tolerance")
         else _stereo_band_case(n, m, dev, kind))
    chunks = kernels.stereo_chunks(m)
    assert len(chunks) == -(-m // kernels.STEREO_CHUNK)
    before = kernels.launch_counts()["hamming_best_two_stereo"]
    got = kernels.hamming_best_two_stereo(**c, max_disparity=128.0)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["hamming_best_two_stereo"] == before + len(chunks)
    want = kernels.hamming_best_two_stereo_ref(**c, max_disparity=128.0)
    model = kernels.hamming_best_two_stereo_banded_ref(
        **{k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in c.items()},
        max_disparity=128.0)
    for g, w, b, what in zip(got, want, model, ("idx", "best", "second")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
        assert torch.equal(g.cpu(), b), what
    assert int((got[1] < kernels.BIG).sum()) > 10
    if kind == "reversed_ties":
        rows = torch.arange(0, n, 6, device=dev)
        assert (got[0][rows] == 10).all() and (got[2][rows] == 0).all()


def test_stereo_band_search_on_a_side_stream_and_in_a_cuda_graph(dev):
    """The stereo kernel on a non-default stream, and captured in a CUDA
    graph and replayed on moved right features."""
    c = _stereo_band_case(1024, 1024, dev, "reversed_ties")
    kernels.hamming_best_two_stereo(**c, max_disparity=128.0)   # set-up before capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kernels.hamming_best_two_stereo(**c, max_disparity=128.0)
    side.synchronize()
    want = kernels.hamming_best_two_stereo_ref(**c, max_disparity=128.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernels.hamming_best_two_stereo(**c, max_disparity=128.0)
    c["uvR"][:, 1] += 1.25
    c["uvR"][:, 0] -= 3.0
    graph.replay()
    torch.cuda.synchronize()
    want = kernels.hamming_best_two_stereo_ref(**c, max_disparity=128.0)
    assert all(torch.equal(g, w) for g, w in zip(captured, want))
    assert int((captured[1] < kernels.BIG).sum()) > 10


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
        got_v = [kernels.hamming_best_two_valid(d1, v1, d2, v2)]
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
    seventeen = [_noise((8, 8), k, dev) for k in range(17)]
    got = kernels.fast_score_nms_levels(seventeen, 7.0)
    assert all(torch.equal(g, w) for g, w in
               zip(got, kernels.fast_score_nms_levels_ref(seventeen, 7.0)))
    with pytest.raises(ValueError):
        kernels.hamming_matrix(torch.zeros((4, 8), device=dev, dtype=torch.int32),
                               torch.zeros((4, 4), device=dev, dtype=torch.int32))
    d = torch.zeros((4, 8), device=dev, dtype=torch.int32)
    v = torch.ones(4, device=dev, dtype=torch.bool)
    with pytest.raises(ValueError):
        kernels.hamming_best_two_valid(d, v.to(torch.uint8), d, v)
    with pytest.raises(ValueError):
        kernels.hamming_best_two_valid(d, v, d, v[:3])
    with pytest.raises(TypeError):
        kernels.hamming_best_two_valid(d, v, d, v, inner="mma")    # one route only
    c = _stereo_case(64, kernels.STEREO_CHUNK + 1, dev, "random")
    got = kernels.hamming_best_two_stereo(**c, max_disparity=128.0)
    want = kernels.hamming_best_two_stereo_ref(**c, max_disparity=128.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    c = _stereo_case(64, kernels.STEREO_CHUNK, dev, "random")
    with pytest.raises(ValueError):
        kernels.hamming_best_two_stereo(**dict(c, uvR=c["uvR"].double()),
                                        max_disparity=128.0)


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
    assert counts["hamming_best_two_valid"] > 0, counts
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


@pytest.mark.parametrize("keep,ties", [(0.04, False), (0.04, True), (0.75, False),
                                       (0.75, True)])
def test_validity_match_at_the_collab_arena_shape(dev, keep, ties):
    """32768 x 32768, the collaborative server's map x map cascade (two
    agents of 16384 landmarks), about 4% and 75% valid, with and without
    duplicated descriptors across the column splits: exact."""
    n = 32768
    g = torch.Generator(device=dev)
    g.manual_seed(int(keep * 100))
    words = lambda: torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 8), generator=g, device=dev,
                                  dtype=torch.int64).to(torch.int32)
    d1, d2 = words(), words()
    v1 = torch.rand(n, generator=g, device=dev) < keep
    v2 = torch.rand(n, generator=g, device=dev) < keep
    if ties:
        d2[::97] = d2[5]
        d1[::89] = d2[5]
    got = kernels.hamming_best_two_valid(d1, v1, d2, v2)
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


def _smoke():
    """chip_smoke.py, whose kernels phase builds the matchers' edge cases
    (proj_edge_case, valid_edge_case); imported inside the card tests
    alone, since it blocks JAX for the process that imports it."""
    import importlib
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("kind", ["cell_borders", "outside_nan_inf", "inf_radius",
                                  "slack_all", "all_invalid", "one_row", "one_col",
                                  "off_tiles", "m4608", "past_launch"])
def test_projection_grid_search_edge_cases(dev, kind):
    """The grid-indexed window search against the plain version on the
    edge cases of chip_smoke.proj_edge_case: exact, one launch up to
    PROJ_CHUNK columns."""
    smoke = _smoke()
    n, m = smoke.proj_edge_shape(kind)
    c = smoke.proj_edge_case(kind, dict(_projection_case(n, m, dev), level_slack=1))
    before = kernels.launch_counts()["hamming_best_two_projection"]
    got = kernels.hamming_best_two_projection(**c)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["hamming_best_two_projection"] - before
    assert launches == len(kernels.projection_chunks(c["feat_desc"].shape[0]))
    want = kernels.hamming_best_two_projection_ref(**c)
    for g, w, what in zip(got, want, ("idx", "best", "second")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
    if kind == "cell_borders":
        assert int((got[1] == 0).sum()) > 10000


@pytest.mark.parametrize("kind", ["all_invalid", "one_row", "one_col", "off_tiles",
                                  "ties_across_splits", "full"])
def test_validity_compacted_search_edge_cases(dev, kind):
    """The compacted tensor-core search against the plain version on the
    edge cases of chip_smoke.valid_edge_case (nothing valid, one valid row
    or column, shapes off the tiles, one descriptor in rows of several row
    tiles and columns of several splits) and all valid."""
    smoke = _smoke()
    n, m = smoke.valid_edge_shape(kind)
    d1, v1, d2, v2 = smoke.valid_edge_case(
        kind, *_match_case(n, m, dev, True, 1.0 if kind == "full" else 0.75))
    got = kernels.hamming_best_two_valid(d1, v1, d2, v2)
    torch.cuda.synchronize()
    want = kernels.hamming_best_two_valid_ref(d1, v1, d2, v2)
    for g, w, what in zip(got, want, ("idx", "best", "second", "argmin_row")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
    if kind == "ties_across_splits":
        assert smoke.valid_ties_hold(got)


def test_matchers_device_launches_a_call(dev):
    """The nodes of a CUDA graph of one call (profiling.common's
    graph_launches) count what torch.profiler counts in a fresh process:
    three device launches a validity match, one a projection match."""
    from multi_orbslam3_tpu_torch.profiling import common
    d1, v1, d2, v2 = _match_case(1024, 1024, dev, True)
    c = dict(_projection_case(16384, 1024, dev), level_slack=2)
    fns = {"valid": (lambda: kernels.hamming_best_two_valid(d1, v1, d2, v2), 3),
           "projection": (lambda: kernels.hamming_best_two_projection(**c), 1)}
    for name, (fn, want) in fns.items():
        assert common.graph_launches(fn, dev) == want, name
        assert common.launches(fn, dev) == want, name


def test_both_matchers_replay_from_a_cuda_graph(dev):
    """Both fused matches captured in one CUDA graph (no read-back, no
    allocation the capture cannot hold) and replayed on new inputs."""
    d1, v1, d2, v2 = _match_case(1024, 1024, dev, True)
    c = dict(_projection_case(16384, 1024, dev), level_slack=2)
    kernels.hamming_best_two_valid(d1, v1, d2, v2)          # set-up before capture
    kernels.hamming_best_two_projection(**c)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got_v = kernels.hamming_best_two_valid(d1, v1, d2, v2)
        got_p = kernels.hamming_best_two_projection(**c)
    rng = np.random.RandomState(41)
    d1.copy_(_words(rng, 1024, dev))
    v2.copy_(torch.from_numpy(rng.rand(1024) < 0.5).to(dev))
    c["proj_uv"].add_(torch.from_numpy(rng.normal(0, 2, (16384, 2)).astype(np.float32)).to(dev))
    c["proj_valid"].copy_(torch.from_numpy(rng.rand(16384) < 0.3).to(dev))
    graph.replay()
    torch.cuda.synchronize()
    want_v = kernels.hamming_best_two_valid_ref(d1, v1, d2, v2)
    want_p = kernels.hamming_best_two_projection_ref(**c)
    assert all(torch.equal(g, w) for g, w in zip(got_v, want_v))
    assert all(torch.equal(g, w) for g, w in zip(got_p, want_p))


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


# ----------------------------------------------------------------------
# The motion-only pose optimisation (csrc/pose_opt.cu)
# ----------------------------------------------------------------------

POSE_CASES = [(0, "stereo", 2, 7), (1, "mono", 4, 10), (1, "stereo", 2, 7),
              (1280, "stereo", 2, 7), (1280, "mixed", 3, 8), (1280, "mono", 4, 10),
              (2000, "mono", 4, 10), (2000, "stereo", 3, 8), (3000, "mixed", 2, 7),
              (9000, "stereo", 2, 7)]


def _pose_case(m, kind, seed, dev):
    """tests/test_torch_pose_opt_kernel.py's case on the card."""
    from test_torch_pose_opt_kernel import _case
    from multi_orbslam3_tpu_torch.geometry import camera as cam
    c = _case(m, seed, kind)
    out = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in c.items()}
    out["K"] = cam.PinholeK(*(v.to(dev) for v in c["K"]))
    return out


def _same(got, want) -> bool:
    return all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("m,kind,rounds,iters", POSE_CASES)
def test_pose_opt_kernel_equals_its_model_and_the_plain_version(dev, m, kind, rounds, iters):
    """One launch a call; bit for bit the CPU model run on the card (torch's
    float32 ops there round as the kernel's do); against the plain version
    the centre within 1e-5 m (one row: 1e-4, the module docstring of
    test_torch_pose_opt_kernel.py) and the inliers equal but for rows
    within 1e-4 of their threshold; 9,000 rows reach past the registers
    and shared memory into rows read again from global memory."""
    from test_torch_pose_opt_kernel import assert_close_to_plain
    from multi_orbslam3_tpu_torch.opt import pose_opt
    c = _pose_case(m, kind, 100 * m + 10 * rounds + iters, dev)
    before = kernels.launch_counts()["pose_optimization"]
    got = pose_opt.pose_optimization(**c, rounds=rounds, iters=iters)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["pose_optimization"] == before + 1
    model = pose_opt.pose_opt_kernel_model(**c, rounds=rounds, iters=iters)
    assert _same(got, model), (got, model)
    want = pose_opt.pose_optimization_ref(**c, rounds=rounds, iters=iters)
    assert_close_to_plain(got, want, c, centre_m=1e-4 if m == 1 else 1e-5)
    again = pose_opt.pose_optimization(**c, rounds=rounds, iters=iters)
    assert _same(got, again)


def test_pose_opt_kernel_is_one_device_launch_and_sync_free(dev):
    """One device launch (a CUDA graph of one call), no sync flagged under
    sync debug mode "error", from the kernel's wrapper and from
    pose_optimization (which adds the stack of the intrinsics)."""
    from multi_orbslam3_tpu_torch.opt import pose_opt
    from multi_orbslam3_tpu_torch.profiling import common
    c = _pose_case(1280, "stereo", 5, dev)
    cam4 = torch.stack(list(c["K"]))
    args = (c["T_init"], cam4, c["p_world"], c["uv_obs"], c["inv_sigma2"], c["mask"], 2, 7,
            5.991, c["u_r"], c["bf"])
    assert common.graph_launches(lambda: kernels.pose_optimization(*args), dev) == 1
    assert common.graph_launches(lambda: pose_opt.pose_optimization(**c, rounds=2, iters=7),
                                 dev) == 2
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pose_opt.pose_optimization(**c, rounds=2, iters=7)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_pose_opt_kernel_replays_from_a_cuda_graph(dev):
    """Captured once, replayed on moved observations and a new start pose:
    equal to the eager call on those inputs."""
    from multi_orbslam3_tpu_torch.opt import pose_opt
    c = _pose_case(1280, "mixed", 9, dev)
    pose_opt.pose_optimization(**c, rounds=2, iters=7)          # set-up before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pose_opt.pose_optimization(**c, rounds=2, iters=7)
    c["uv_obs"].add_(0.75)
    c["T_init"][0, 3] = 0.05
    graph.replay()
    torch.cuda.synchronize()
    assert _same(captured, pose_opt.pose_optimization(**c, rounds=2, iters=7))


def test_pose_opt_kernel_on_a_card_that_is_not_current(dev):
    """Tensors on the last card while the first is current (each agent of
    the multi-card dry run keeps its own card): the kernel runs there, on
    that card's stream, and gives what it gives on the first card."""
    from multi_orbslam3_tpu_torch.opt import pose_opt
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA GPUs")
    other = torch.device("cuda", n - 1)
    c0 = _pose_case(1280, "stereo", 13, torch.device("cuda", 0))
    c1 = _pose_case(1280, "stereo", 13, other)
    with torch.cuda.device(0):
        got = pose_opt.pose_optimization(**c1, rounds=2, iters=7)
        want = pose_opt.pose_optimization(**c0, rounds=2, iters=7)
    assert all(t.device == other for t in got)
    torch.cuda.synchronize(other)
    assert _same([t.cpu() for t in got], [t.cpu() for t in want])


def test_pose_opt_kernel_rejects_what_it_does_not_take(dev):
    c = _pose_case(64, "stereo", 1, dev)
    cam4 = torch.stack(list(c["K"]))
    args = [c["T_init"], cam4, c["p_world"], c["uv_obs"], c["inv_sigma2"], c["mask"], 2, 7,
            5.991, c["u_r"], c["bf"]]
    for i, bad in ((0, c["T_init"].double()), (2, c["p_world"][:, :2].contiguous()),
                   (5, c["mask"].to(torch.uint8)), (9, c["u_r"][:10]),
                   (2, c["p_world"].cpu())):
        with pytest.raises(ValueError):
            kernels.pose_optimization(*(args[:i] + [bad] + args[i + 1:]))
    with pytest.raises(ValueError):
        kernels.pose_optimization(*(args[:6] + [-1] + args[7:]))


def test_pose_opt_kernel_on_the_cells_tracking_calls(dev, monkeypatch):
    """The cell euroc_stereo.revisit (slambench/): 40 frames of its traffic
    through StereoSlam, every pose optimisation they call recorded, each
    held bit for bit to the model and to the plain version as above; the
    rows whose inlier flag differs are counted (all near a threshold)."""
    from test_torch_pose_opt_kernel import assert_close_to_plain
    from multi_orbslam3_tpu_torch.geometry import camera as cam
    from multi_orbslam3_tpu_torch.opt import pose_opt
    from multi_orbslam3_tpu_torch.pipeline.stereo_system import StereoSlam
    from slambench.harness import cell as cellm
    from slambench.harness import traffic
    c = cellm.load_cell("euroc_stereo.revisit")
    cfg = cellm.system_config(c.config)
    tfc = dict(c.traffic, frames_per_agent=40)
    fr = traffic.generate(tfc, cfg.camera, 2 ** 31 + 7, dev)[0]
    calls, real = [], kernels.pose_optimization

    def record(*args):
        out = real(*args)
        calls.append(([a.clone() if isinstance(a, torch.Tensor) else a for a in args],
                      [o.clone() for o in out]))
        return out

    monkeypatch.setattr(kernels, "pose_optimization", record)
    slam = StereoSlam(cfg, enable_loop_closing=True, device=dev)
    for i in range(fr.left.shape[0]):
        slam.process_frame_stereo_pipelined(fr.left[i], fr.right[i], float(fr.timestamps[i]))
    slam.finish()
    monkeypatch.undo()
    assert len(calls) >= 60
    differ = 0
    for (T0, cam4, pw, uv, s2, mask, rounds, iters, chi2_th, u_r, bf), out in calls:
        K = cam.PinholeK(*cam4.unbind(0))
        c = dict(T_init=T0, K=K, p_world=pw, uv_obs=uv, inv_sigma2=s2, mask=mask, u_r=u_r,
                 bf=bf)
        got = pose_opt.PoseOptResult(*out)
        assert _same(got, pose_opt.pose_opt_kernel_model(**c, rounds=rounds, iters=iters,
                                                         chi2_th=chi2_th))
        want = pose_opt.pose_optimization_ref(**c, rounds=rounds, iters=iters,
                                              chi2_th=chi2_th)
        differ += assert_close_to_plain(got, want, c)
    print(f"pose optimisations: {len(calls)}; inlier rows that differ (near a threshold): "
          f"{differ}")
