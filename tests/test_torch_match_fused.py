"""The port's matchers, routed through the plain versions of kernel K2's
fused entry points (hamming_best_two_valid / hamming_best_two_projection),
against the JAX package's match_mutual / match_by_projection on the CPU
(their XLA path). Inputs are made with numpy from a seed and handed to
both; every comparison is exact (integers, comparisons, min/max only).

On the GPU the fused kernels are held against the same plain versions by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.frontend import matcher as jm
from multi_orbslam3_tpu_torch.frontend import kernels
from multi_orbslam3_tpu_torch.frontend import matcher as tm


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def words(rng, n):
    return rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def i32(a):
    return t(np.ascontiguousarray(a).view(np.int32))


def mutual_case(seed, n, m, ties):
    """Descriptors of n rows and m columns; with `ties`, every 7th column
    repeats its left neighbour and every 5th row is an exact copy of a
    column (so best == second and first-index ties occur), row 3 and
    column 2 are fully masked."""
    rng = np.random.RandomState(seed)
    d1, d2 = words(rng, n), words(rng, m)
    v1, v2 = rng.rand(n) < 0.8, rng.rand(m) < 0.8
    if ties:
        d2[7::7] = d2[6:-1:7][: len(d2[7::7])]
        src = rng.randint(0, m, n)
        near = d2[src] ^ (np.uint32(1) << rng.randint(0, 32, (n, 8)).astype(np.uint32))
        d1[::2] = near[::2]
        d1[::5] = d2[src][::5]
        v1[min(3, n - 1)], v2[min(2, m - 1)] = False, False
    return d1, v1, d2, v2


@pytest.mark.parametrize("n,m,ties,seed", [(300, 77, False, 0), (300, 77, True, 1),
                                           (64, 130, True, 2), (1, 5, False, 3),
                                           (9, 1, True, 4)])
@pytest.mark.parametrize("ratio", [0.9, 1.0])
def test_match_mutual_matches_jax(n, m, ties, seed, ratio):
    """Exact idx and dist; sizes that are multiples of no tile."""
    d1, v1, d2, v2 = mutual_case(seed, n, m, ties)
    rj = jm.match_mutual(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2),
                         jnp.asarray(v2), max_dist=256, ratio=ratio)
    rt = tm.match_mutual(i32(d1), t(v1), i32(d2), t(v2), max_dist=256, ratio=ratio)
    np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
    np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))
    if ties and n > 50:
        assert int(rt.count) > 5


def test_best_two_valid_plain_on_ties_and_empty_rows():
    """The fused entry point's contract on the CPU: first-index ties,
    second == best for duplicated columns, (0, BIG, BIG) for a masked row,
    0 for a masked column."""
    d1, v1, d2, v2 = mutual_case(5, 40, 29, True)
    idx, best, second, col = kernels.hamming_best_two_valid(i32(d1), t(v1), i32(d2), t(v2))
    dist = np.asarray(jm.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    dist = np.where(v1[:, None] & v2[None, :], dist, kernels.BIG)
    np.testing.assert_array_equal(idx.numpy(), dist.argmin(1))
    np.testing.assert_array_equal(best.numpy(), dist.min(1))
    rest = dist.copy()
    rest[np.arange(40), dist.argmin(1)] = kernels.BIG
    np.testing.assert_array_equal(second.numpy(), rest.min(1))
    np.testing.assert_array_equal(col.numpy(), dist.argmin(0))
    assert (idx[3], best[3], second[3]) == (0, kernels.BIG, kernels.BIG)
    assert col[2] == 0
    dup = (best == second) & (best < kernels.BIG)
    assert int(dup.sum()) > 0
    assert idx.dtype == col.dtype == torch.int64
    assert best.dtype == second.dtype == torch.int32


def projection_case(seed, n, m):
    """n projected map points against m features: descriptors with planted
    near duplicates, exact duplicates among the features (ties), positions
    on a half-pixel grid so that many pairs lie exactly on the radius, a
    fully masked row and column."""
    rng = np.random.RandomState(seed)
    feat_desc = words(rng, m)
    feat_desc[5::7] = feat_desc[4:-1:7][: len(feat_desc[5::7])]
    src = rng.randint(0, m, n)
    mp_desc = feat_desc[src].copy()
    flip = rng.rand(n, 8) < 0.3
    mp_desc ^= (flip * (1 << rng.randint(0, 32, (n, 8)))).astype(np.uint32)
    feat_uv = (np.round(rng.uniform(0, 60, (m, 2)) * 2) / 2).astype(np.float32)
    feat_uv[5::7] = feat_uv[4:-1:7][: len(feat_uv[5::7])]
    proj_uv = (feat_uv[src] + np.round(rng.normal(0, 2, (n, 2)) * 2) / 2).astype(np.float32)
    proj_valid = rng.rand(n) < 0.9
    feat_valid = rng.rand(m) < 0.95
    proj_valid[min(3, n - 1)] = False
    feat_valid[min(2, m - 1)] = False
    feat_level = rng.randint(0, 4, m).astype(np.int32)
    pred_level = rng.randint(0, 4, n).astype(np.int32)
    radius = rng.choice([2.5, 5.0, 6.5, 10.0], n).astype(np.float32)
    return dict(proj_uv=proj_uv, proj_valid=proj_valid, mp_desc=mp_desc,
                feat_uv=feat_uv, feat_valid=feat_valid, feat_desc=feat_desc,
                feat_level=feat_level, radius=radius, pred_level=pred_level)


def both_projection(case, radius, **kw):
    c = case
    rj = jm.match_by_projection(
        jnp.asarray(c["proj_uv"]), jnp.asarray(c["proj_valid"]), jnp.asarray(c["mp_desc"]),
        jnp.asarray(c["feat_uv"]), jnp.asarray(c["feat_valid"]), jnp.asarray(c["feat_desc"]),
        jnp.asarray(c["feat_level"]),
        jnp.asarray(radius) if isinstance(radius, np.ndarray) else radius,
        jnp.asarray(c["pred_level"]), **kw)
    rt = tm.match_by_projection(
        t(c["proj_uv"]), t(c["proj_valid"]), i32(c["mp_desc"]), t(c["feat_uv"]),
        t(c["feat_valid"]), i32(c["feat_desc"]), t(c["feat_level"]),
        t(radius) if isinstance(radius, np.ndarray) else radius,
        t(c["pred_level"]), **kw)
    return rj, rt


@pytest.mark.parametrize("n,m,seed", [(300, 77, 0), (120, 300, 1), (5, 3, 2)])
@pytest.mark.parametrize("radius", ["tensor", 5.0])
@pytest.mark.parametrize("level_slack", [1, 2])
def test_match_by_projection_matches_jax(n, m, seed, radius, level_slack):
    """Exact idx and dist, with the radius as a per-row tensor and as a
    float, level_slack 1 and 2."""
    case = projection_case(seed, n, m)
    r = case["radius"] if radius == "tensor" else radius
    rj, rt = both_projection(case, r, max_dist=100, ratio=0.9, level_slack=level_slack)
    np.testing.assert_array_equal(rt.idx.numpy(), np.asarray(rj.idx))
    np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))
    if n >= 100:
        assert int(rt.count) > 20


def test_best_two_projection_plain_on_the_radius_edge_and_empty_rows():
    """The fused entry point's contract on the CPU against numpy: pairs
    exactly on the radius are inside, the masked row gives (0, BIG, BIG),
    duplicated features tie with second == best."""
    c = projection_case(6, 200, 90)
    idx, best, second = kernels.hamming_best_two_projection(
        i32(c["mp_desc"]), t(c["proj_uv"]), t(c["proj_valid"]), t(c["radius"]),
        t(c["pred_level"]), i32(c["feat_desc"]), t(c["feat_uv"]), t(c["feat_valid"]),
        t(c["feat_level"]), 1)
    diff = c["proj_uv"][:, None, :] - c["feat_uv"][None, :, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    r2 = (c["radius"] * c["radius"])[:, None]
    assert int((d2 == r2).sum()) > 0        # the edge case occurs
    mask = ((d2 <= r2) & (np.abs(c["feat_level"][None] - c["pred_level"][:, None]) <= 1)
            & c["proj_valid"][:, None] & c["feat_valid"][None])
    dist = np.asarray(jm.hamming_matrix(jnp.asarray(c["mp_desc"]), jnp.asarray(c["feat_desc"])))
    dist = np.where(mask, dist, kernels.BIG)
    np.testing.assert_array_equal(idx.numpy(), dist.argmin(1))
    np.testing.assert_array_equal(best.numpy(), dist.min(1))
    rest = dist.copy()
    rest[np.arange(200), dist.argmin(1)] = kernels.BIG
    np.testing.assert_array_equal(second.numpy(), rest.min(1))
    assert (idx[3], best[3], second[3]) == (0, kernels.BIG, kernels.BIG)
    assert int(((best == second) & (best < kernels.BIG)).sum()) > 0


def test_empty_sides_give_empty_matches():
    d = torch.zeros((4, 8), dtype=torch.int32)
    e = torch.zeros((0, 8), dtype=torch.int32)
    v, ve = torch.ones(4, dtype=torch.bool), torch.ones(0, dtype=torch.bool)
    idx, best, second, col = kernels.hamming_best_two_valid(d, v, e, ve)
    assert idx.tolist() == [0] * 4 and best.tolist() == [kernels.BIG] * 4
    assert second.tolist() == [kernels.BIG] * 4 and col.shape == (0,)
    idx, best, second, col = kernels.hamming_best_two_valid(e, ve, d, v)
    assert idx.shape == (0,) and col.tolist() == [0] * 4
