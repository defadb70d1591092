"""K2's two fused matchers as the H100 kernels compute them, on the CPU:
the forms of the CUDA kernels against the plain versions and the JAX
package.

- The projection match: csrc/hamming.cu indexes the valid columns by 16-px
  cell in shared memory and visits, per row, the overflow list and the
  cells of its window's square with one spare cell on each side, in an
  order that is not column order (or every column, where the square is not
  finite or covers more cells than the index holds columns).
  kernels.projection_window_candidates is that visit and
  kernels.hamming_best_two_projection_gridded_ref the search on it.
- The validity match: csrc/hamming_mma.cu compacts the valid rows and
  columns, splits the compacted columns of a row tile across blocks and
  merges the splits' statistics on the device; the column argmin is an
  atomicMin of (distance << 32 | row) keys.
  kernels.hamming_best_two_valid_compacted_ref is that search, its work
  items and splits run last first, the atomicMin modelled by a minimum.
Both equal the plain versions and JAX's matcher (match_by_projection,
match_mutual, _best_two on the masked hamming_matrix) on random cases, on
pairs exactly on the radius at cell borders, on positions outside the
image, at NaN and infinity, with an infinite radius and a level slack of
every level, with nothing or one thing valid, at shapes that are not
multiples of a tile and past one launch; each also under a hypothesis
property. The wrappers' CUDA paths run through a stand-in for the launch.
Expect equality: everything here is integers and comparisons.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from multi_orbslam3_tpu.frontend import matcher as jmatcher
from multi_orbslam3_tpu_torch.frontend import kernels
from multi_orbslam3_tpu_torch.frontend import matcher as tmatcher

torch.set_num_threads(2)

BIG = kernels.BIG
F32 = np.float32


def _words(rng, n):
    return rng.randint(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64).astype(np.int32)


def _to_torch(c):
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v)
            for k, v in c.items()}


def _jax_hamming(d1, d2):
    return jmatcher.hamming_matrix(jnp.asarray(d1.view(np.uint32)),
                                   jnp.asarray(d2.view(np.uint32)))


# ----------------------------------------------------------------------
# the projection match: the grid-indexed window search's CPU model
# ----------------------------------------------------------------------

def _proj_case(rng, n, m, width=752.0, height=480.0, keep=0.75, copy=0.5, n_levels=8,
               sigma=6.0):
    """Rows projected near the features they were made from, on a half-pixel
    grid (pairs exactly on the radius occur), a share copying their
    descriptor; radii of the tracking, fuse and loop searches."""
    dC = _words(rng, m)
    feat_uv = (np.round(rng.uniform(0, 1, (m, 2)) * np.array([width, height]) * 2) / 2
               ).astype(F32)
    src = rng.randint(0, m, n)
    proj_uv = (feat_uv[src] + np.round(rng.normal(0, sigma, (n, 2)) * 2) / 2).astype(F32)
    dR = np.where((rng.rand(n) < copy)[:, None], dC[src], _words(rng, n))
    radius = rng.choice([2.5, 3.0, 4.0, 5.0, 6.5, 10.0, 15.0, 25.92], n).astype(F32)
    return dict(mp_desc=dR, proj_uv=proj_uv, proj_valid=rng.rand(n) < keep, radius=radius,
                pred_level=rng.randint(0, n_levels, n).astype(np.int32), feat_desc=dC,
                feat_uv=feat_uv, feat_valid=rng.rand(m) < keep,
                feat_level=rng.randint(0, n_levels, m).astype(np.int32), level_slack=1)


def _jax_projection(c):
    """JAX's match_by_projection mask, then _best_two."""
    proj_uv, feat_uv = jnp.asarray(c["proj_uv"]), jnp.asarray(c["feat_uv"])
    d2 = jnp.sum((proj_uv[:, None, :] - feat_uv[None, :, :]) ** 2, axis=-1)
    r = jnp.broadcast_to(jnp.asarray(c["radius"], jnp.float32), (proj_uv.shape[0],))
    mask = ((d2 <= r[:, None] ** 2)
            & (jnp.abs(jnp.asarray(c["feat_level"])[None, :]
                       - jnp.asarray(c["pred_level"])[:, None]) <= c["level_slack"])
            & jnp.asarray(c["proj_valid"])[:, None] & jnp.asarray(c["feat_valid"])[None, :])
    dist = jnp.where(mask, _jax_hamming(c["mp_desc"], c["feat_desc"]), jmatcher.BIG)
    return tuple(np.asarray(x) for x in jmatcher._best_two(dist))


def _check_proj(c, jax_too=True, min_matched=1):
    """Gridded model == plain version (== JAX); returns the model's result."""
    t = _to_torch(c)
    got = kernels.hamming_best_two_projection_gridded_ref(**t)
    want = kernels.hamming_best_two_projection_ref(**t)
    for g, w, what in zip(got, want, ("idx", "best", "second")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
    if jax_too:
        for g, j in zip(got, _jax_projection(c)):
            np.testing.assert_array_equal(g.numpy(), j)
    assert int((got[1] < BIG).sum()) >= min_matched
    return got


def _visits(c):
    t = _to_torch(c)
    return kernels.projection_window_candidates(t["proj_uv"], t["proj_valid"], t["radius"],
                                                t["feat_uv"], t["feat_valid"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gridded_projection_equals_plain_and_jax_on_random_cases(seed):
    rng = np.random.RandomState(seed)
    c = _proj_case(rng, 400, 300)
    got = _check_proj(c, min_matched=40)
    visited = sum(len(v) for v in _visits(c))
    assert visited < 0.1 * 400 * 300                 # the window's cells, not every column
    assert int((got[1] >= BIG).sum()) > 0


def test_gridded_projection_on_the_radius_at_cell_borders():
    """Pairs exactly on the radius (d2 == r*r in float32), one float32 step
    beyond it, with the feature and the window's edges on cell borders
    (multiples of 16 px) and one step either side of them, at each radius
    of the tracking and fuse searches: inside exactly where the plain
    version says so."""
    rows, feats = [], []
    k = 0
    for r in (2.5, 3.0, 4.0, 15.0, 16.0, 32.0):
        for fx in (F32(160.0), np.nextafter(F32(160.0), F32(0)), np.nextafter(F32(160.0), F32(1e9))):
            for du in (F32(r), np.nextafter(F32(r), F32(1e9)), F32(-r), F32(0.0)):
                y = F32(48.0 + 64.0 * k)               # one pair a cell row band
                feats.append((fx, y))
                rows.append((F32(fx + du), y, F32(r)))
                k += 1
    n = len(rows)
    desc = _words(np.random.RandomState(3), n)
    c = dict(mp_desc=desc, proj_uv=np.array([r[:2] for r in rows], F32),
             proj_valid=np.ones(n, bool), radius=np.array([r[2] for r in rows], F32),
             pred_level=np.zeros(n, np.int32), feat_desc=desc.copy(),
             feat_uv=np.array(feats, F32), feat_valid=np.ones(n, bool),
             feat_level=np.zeros(n, np.int32), level_slack=0)
    got = _check_proj(c)
    d2 = ((c["proj_uv"] - c["feat_uv"]) ** 2).sum(1).astype(F32)
    on = d2 == c["radius"] * c["radius"]
    assert on.sum() >= 18                            # pairs exactly on the radius
    assert (got[1].numpy()[on] == 0).all()           # all of them matched their feature


def test_gridded_projection_outside_the_image_and_at_nan_and_inf():
    """Features left of and below the image, a hair below 0, at |u| >= 2^20,
    at +-inf and NaN; rows at NaN, at inf and far out; the overflow list
    holds the unindexable columns and every row visits it."""
    rng = np.random.RandomState(5)
    c = _proj_case(rng, 120, 100)
    c["feat_uv"][:4] = np.array([[-50.0, 30.0], [400.0, 620.0], [-1e-8, 5.0],
                                 [760.0, -33.5]], F32)
    c["feat_uv"][4:10] = np.array([[2.0 ** 20, 1.0], [1.0, -2.0 ** 21], [np.inf, 3.0],
                                   [-np.inf, 3.0], [np.nan, 4.0], [5.0, np.nan]], F32)
    c["feat_valid"][:10] = True
    c["proj_uv"][:4] = c["feat_uv"][:4] + np.array([1.0, -1.0], F32)
    c["mp_desc"][:4] = c["feat_desc"][:4]
    c["pred_level"][:4] = c["feat_level"][:4]
    c["proj_valid"][:4] = True
    c["proj_uv"][4] = np.array([np.nan, 3.0], F32)
    c["proj_uv"][5] = np.array([np.inf, 3.0], F32)
    c["proj_uv"][6] = np.array([3e6, 3.0], F32)
    c["proj_valid"][4:7] = True
    got = _check_proj(c, min_matched=10)
    assert (got[1].numpy()[:4] == 0).all()
    overflow = set(range(4, 10))
    for v, ok in zip(_visits(c), c["proj_valid"]):
        if ok:
            assert overflow <= set(v.tolist())


@pytest.mark.parametrize("radius", [np.inf, 1e30, "row_inf"])
def test_gridded_projection_with_an_infinite_radius(radius):
    """An infinite radius (and one whose square overflows to infinity)
    passes every finite pair and, as inf <= inf, features at infinity: the
    row walks every column and the overflow list."""
    rng = np.random.RandomState(7)
    c = _proj_case(rng, 90, 80)
    c["feat_uv"][:2] = np.array([[np.inf, 2.0], [3.0, -np.inf]], F32)
    c["feat_valid"][:2] = True
    if radius == "row_inf":
        c["radius"][::3] = np.inf
    else:
        c["radius"] = float(radius)
    got = _check_proj(c, min_matched=20)
    rows = np.flatnonzero(c["proj_valid"] & (np.isinf(c["radius"]) if radius == "row_inf"
                                             else True))
    visits = _visits(c)
    assert all(len(visits[i]) == int(c["feat_valid"].sum()) for i in rows)
    assert (got[1].numpy()[rows] < BIG).all()


def test_gridded_projection_with_a_level_slack_of_every_level():
    """The loop closer's search: level gating off (level_slack = n_levels),
    radius 8 x 1.2^level."""
    rng = np.random.RandomState(9)
    c = _proj_case(rng, 300, 256)
    c["radius"] = (F32(8.0) * (np.float64(F32(1.2)) ** c["pred_level"]).astype(F32)).astype(F32)
    c["level_slack"] = 8
    _check_proj(c, min_matched=40)


def test_gridded_projection_with_nothing_or_one_thing_valid():
    rng = np.random.RandomState(11)
    c = _proj_case(rng, 70, 50)
    none_rows = dict(c, proj_valid=np.zeros(70, bool))
    got = _check_proj(none_rows, min_matched=0)
    assert (got[1] == BIG).all() and (got[2] == BIG).all() and (got[0] == 0).all()
    none_cols = dict(c, feat_valid=np.zeros(50, bool))
    got = _check_proj(none_cols, min_matched=0)
    assert (got[1] == BIG).all()
    one_row = dict(c, proj_valid=np.eye(70, dtype=bool)[17])
    one_row["proj_uv"] = c["proj_uv"].copy()
    one_row["proj_uv"][17] = c["feat_uv"][3]
    one_row["mp_desc"] = c["mp_desc"].copy()
    one_row["mp_desc"][17] = c["feat_desc"][3]
    one_row["feat_valid"] = c["feat_valid"].copy()
    one_row["feat_valid"][3] = True
    one_row["pred_level"] = c["pred_level"].copy()
    one_row["pred_level"][17] = c["feat_level"][3]
    got = _check_proj(one_row)
    assert int(got[0][17]) == 3 and int(got[1][17]) == 0
    one_col = dict(c, feat_valid=np.eye(50, dtype=bool)[0])
    _check_proj(one_col, min_matched=0)


@pytest.mark.parametrize("n,m", [(1, 1), (65, 1), (63, 130), (513, 257)])
def test_gridded_projection_at_shapes_off_the_tiles(n, m):
    """Rows not a multiple of a block's 64, columns not a multiple of its
    512 threads."""
    rng = np.random.RandomState(n + m)
    _check_proj(_proj_case(rng, n, m, keep=0.9), min_matched=0)


def test_gridded_projection_past_the_grid_cap():
    """Features spread wider than PROJ_MAX_CELLS cells: the grid keeps
    gx x gy <= PROJ_MAX_CELLS, the rest goes to the overflow list."""
    rng = np.random.RandomState(13)
    c = _proj_case(rng, 200, 180, width=120000.0, height=900.0, sigma=2.0)
    t = _to_torch(c)
    cells_x = np.floor(c["feat_uv"][c["feat_valid"], 0] / kernels.PROJ_CELL)
    assert cells_x.max() - cells_x.min() + 1 > kernels.PROJ_MAX_CELLS
    _check_proj(c, min_matched=20)
    visits = kernels.projection_window_candidates(t["proj_uv"], t["proj_valid"], t["radius"],
                                                  t["feat_uv"], t["feat_valid"])
    assert 0 < min(len(v) for v, ok in zip(visits, c["proj_valid"]) if ok)


@pytest.mark.parametrize("m", [4608, kernels.PROJ_CHUNK + 1])
def test_gridded_projection_past_one_launch(m):
    """stereo_wide's 4,608 features (one launch) and one column past a
    launch's PROJ_CHUNK (two launches, the second seeded), with a tied pair
    of columns, one on each side of the chunk border: the first column
    wins whichever chunk merges first."""
    rng = np.random.RandomState(m)
    c = _proj_case(rng, 48, m, keep=0.8)
    b = kernels.PROJ_CHUNK if m > kernels.PROJ_CHUNK else m // 2
    pair = np.array([b - 1, b])
    c["feat_desc"][pair] = c["feat_desc"][b - 1]
    c["feat_uv"][pair] = np.array([[300.0, 200.0], [302.0, 200.0]], F32)
    c["feat_level"][pair] = 2
    c["feat_valid"][pair] = True
    rows = np.arange(0, 48, 5)
    c["mp_desc"][rows] = c["feat_desc"][b - 1]
    c["proj_uv"][rows] = np.array([301.0, 200.0], F32)
    c["pred_level"][rows] = 2
    c["proj_valid"][rows] = True
    c["radius"][rows] = 4.0
    got = _check_proj(c)
    assert (got[0].numpy()[rows] == b - 1).all()
    assert (got[1].numpy()[rows] == 0).all() and (got[2].numpy()[rows] == 0).all()
    assert len(kernels.projection_chunks(m)) == (1 if m <= kernels.PROJ_CHUNK else 2)


def test_gridded_search_on_ties_out_of_column_order():
    """Features sharing one descriptor and one cell reach a row in
    descending column order: the search compares (distance, column)."""
    rng = np.random.RandomState(17)
    c = _proj_case(rng, 60, 90)
    dup = np.array([5, 30, 31, 60, 89])
    c["feat_desc"][dup] = c["feat_desc"][5]
    c["feat_uv"][dup] = np.array([[100.0 + k, 200.0] for k in range(5)], F32)
    c["feat_level"][dup] = 1
    c["feat_valid"][dup] = True
    rows = np.arange(0, 60, 6)
    c["mp_desc"][rows] = c["feat_desc"][5]
    c["proj_uv"][rows] = np.array([102.0, 201.0], F32)
    c["pred_level"][rows] = 1
    c["proj_valid"][rows] = True
    c["radius"][rows] = 6.0
    got = _check_proj(c)
    assert (got[0].numpy()[rows] == 5).all() and (got[2].numpy()[rows] == 0).all()
    order = _visits(c)[rows[0]]
    pos = {int(j): k for k, j in enumerate(order)}
    assert pos[89] < pos[60] < pos[31] < pos[30] < pos[5]


def test_gridded_matcher_equals_jax_match_by_projection(monkeypatch):
    """frontend/matcher.py::match_by_projection with the gridded model in
    place of the fused match gives JAX's match_by_projection."""
    rng = np.random.RandomState(19)
    c = _proj_case(rng, 500, 400)
    t = _to_torch(c)
    want = jmatcher.match_by_projection(
        jnp.asarray(c["proj_uv"]), jnp.asarray(c["proj_valid"]),
        jnp.asarray(c["mp_desc"].view(np.uint32)), jnp.asarray(c["feat_uv"]),
        jnp.asarray(c["feat_valid"]), jnp.asarray(c["feat_desc"].view(np.uint32)),
        jnp.asarray(c["feat_level"]), jnp.asarray(c["radius"]), jnp.asarray(c["pred_level"]),
        level_slack=1)
    monkeypatch.setattr(kernels, "hamming_best_two_projection",
                        kernels.hamming_best_two_projection_gridded_ref)
    got = tmatcher.match_by_projection(t["proj_uv"], t["proj_valid"], t["mp_desc"],
                                       t["feat_uv"], t["feat_valid"], t["feat_desc"],
                                       t["feat_level"], t["radius"], t["pred_level"],
                                       level_slack=1)
    assert int(got.count) > 15
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 80), m=st.integers(1, 80),
       size=st.sampled_from([(20.0, 12.0), (752.0, 480.0), (5000.0, 40.0)]),
       keep=st.sampled_from([0.3, 0.9, 1.0]), copy=st.sampled_from([0.0, 0.6, 1.0]),
       slack=st.sampled_from([0, 1, 2, 8]))
def test_gridded_projection_equals_plain_hypothesis(seed, n, m, size, keep, copy, slack):
    """Random shapes, densities, image extents (a 20 x 12 image: every pair
    in a cell or two, duplicated descriptors common) and level slacks."""
    rng = np.random.RandomState(seed)
    c = _proj_case(rng, n, m, width=size[0], height=size[1], keep=keep, copy=copy)
    c["level_slack"] = slack
    if copy == 1.0:
        c["feat_desc"][rng.randint(0, m, m)] = c["feat_desc"][0]     # many ties
    _check_proj(c, jax_too=False, min_matched=0)


# ----------------------------------------------------------------------
# the validity match: the compacted tensor-core search's CPU model
# ----------------------------------------------------------------------

def _valid_case(rng, n, m, keep=0.75, ties=True):
    d1, d2 = _words(rng, n), _words(rng, m)
    v1, v2 = rng.rand(n) < keep, rng.rand(m) < keep
    if ties and m > 1:
        d2[7::7] = d2[6:-1:7][:d2[7::7].shape[0]]
        src = rng.randint(0, m, n)
        d1[::5] = d2[src][::5]
    return d1, v1, d2, v2


def _jax_valid(d1, v1, d2, v2):
    dist = jnp.where(jnp.asarray(v1)[:, None] & jnp.asarray(v2)[None, :],
                     _jax_hamming(d1, d2), jmatcher.BIG)
    idx, best, second = jmatcher._best_two(dist)
    return tuple(np.asarray(x) for x in (idx, best, second, jnp.argmin(dist, axis=0)))


def _check_valid(d1, v1, d2, v2, grid=528, jax_too=True):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (d1, v1, d2, v2)]
    got = kernels.hamming_best_two_valid_compacted_ref(*t, grid=grid)
    want = kernels.hamming_best_two_valid_ref(*t)
    for g, w, what in zip(got, want, ("idx", "best", "second", "argmin_row")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
    if jax_too:
        for g, j in zip(got, _jax_valid(d1, v1, d2, v2)):
            np.testing.assert_array_equal(g.numpy(), j)
    return got


@pytest.mark.parametrize("grid", [1, 3, 528])
@pytest.mark.parametrize("n,m,keep", [(300, 260, 0.75), (200, 1100, 0.75),
                                      (700, 900, 0.04), (129, 257, 1.0)])
def test_compacted_valid_equals_plain_and_jax(n, m, keep, grid):
    """Random cases with ties, 75%, 4% and all valid, on grids of 1, 3
    and 528 blocks: one split a row tile up to the most the columns allow."""
    rng = np.random.RandomState(n + m + grid)
    got = _check_valid(*_valid_case(rng, n, m, keep), grid=grid)
    if keep == 0.75:
        assert int(((got[1] == got[2]) & (got[1] < BIG)).sum()) > 0    # ties reached


def test_valid_splits_fill_the_grid():
    """The split choice at the callers' shapes (528 blocks: 132 SMs x 4):
    every stage in exactly one split, each split non-empty, and where the
    rows alone fill the grid, one split."""
    for tiles, chunks in ((6, 6), (6, 1), (1, 1), (11, 11), (128, 128), (192, 192),
                          (256, 256), (2, 9)):
        cps, splits = kernels.valid_splits(tiles, chunks, 528)
        assert 1 <= splits <= kernels.VALID_MAX_SPLITS
        assert (splits - 1) * cps < chunks <= splits * cps
    assert kernels.valid_splits(6, 6, 528) == (1, 6)
    assert kernels.valid_splits(1024, 64, 528)[1] == 1


def test_compacted_valid_ties_across_splits_take_the_first_column_and_row():
    """One descriptor in columns of several splits and in rows of several
    row tiles: the first column and the first row win, merged last first."""
    rng = np.random.RandomState(23)
    d1, v1, d2, v2 = _valid_case(rng, 400, 1000, keep=0.9, ties=False)
    cols = np.array([3, 250, 520, 777, 999])
    rows = np.array([10, 140, 270, 399])
    v1[rows] = True
    v2[cols] = True
    d2[cols] = d2[3]
    d1[rows] = d2[3]
    got = _check_valid(d1, v1, d2, v2, grid=528)
    assert (got[0].numpy()[rows] == 3).all() and (got[2].numpy()[rows] == 0).all()
    assert (got[3].numpy()[cols] == 10).all()


def test_compacted_valid_with_nothing_or_one_thing_valid():
    rng = np.random.RandomState(29)
    d1, v1, d2, v2 = _valid_case(rng, 150, 140)
    for a, b in ((np.zeros(150, bool), v2), (v1, np.zeros(140, bool)),
                 (np.eye(150, dtype=bool)[149], v2), (v1, np.eye(140, dtype=bool)[0]),
                 (np.eye(150, dtype=bool)[0], np.eye(140, dtype=bool)[139])):
        got = _check_valid(d1, a, d2, b)
        if not a.any() or not b.any():
            assert (got[1] == BIG).all() and (got[0] == 0).all() and (got[3] == 0).all()


def test_compacted_matcher_equals_jax_match_mutual(monkeypatch):
    """frontend/matcher.py::match_mutual with the compacted model in place
    of the fused match gives JAX's match_mutual."""
    rng = np.random.RandomState(31)
    d1, v1, d2, v2 = _valid_case(rng, 300, 280, keep=0.8)
    d1[::3] = d2[rng.randint(0, 280, 100)]
    want = jmatcher.match_mutual(jnp.asarray(d1.view(np.uint32)), jnp.asarray(v1),
                                 jnp.asarray(d2.view(np.uint32)), jnp.asarray(v2),
                                 max_dist=50, ratio=0.9)
    monkeypatch.setattr(kernels, "hamming_best_two_valid",
                        lambda *a: kernels.hamming_best_two_valid_compacted_ref(*a, grid=3))
    t = [torch.from_numpy(x) for x in (d1, v1, d2, v2)]
    got = tmatcher.match_mutual(*t, max_dist=50, ratio=0.9)
    assert int(got.count) > 30
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 300), m=st.integers(1, 700),
       keep=st.sampled_from([0.02, 0.3, 0.9, 1.0]), grid=st.sampled_from([1, 2, 7, 528]),
       dup=st.booleans())
def test_compacted_valid_equals_plain_hypothesis(seed, n, m, keep, grid, dup):
    rng = np.random.RandomState(seed)
    d1, v1, d2, v2 = _valid_case(rng, n, m, keep, ties=True)
    if dup:
        d2[rng.randint(0, m, m)] = d2[0]
        d1[rng.randint(0, n, n)] = d2[0]
    _check_valid(d1, v1, d2, v2, grid=grid, jax_too=False)


# ----------------------------------------------------------------------
# the wrappers' CUDA paths, with the launch computed on the CPU
# ----------------------------------------------------------------------

class _FakeCard:
    """Stands in for the device in a wrapper: every tensor counts as a CUDA
    tensor, and a launch is computed on the CPU from the pointers the C
    entry receives, mapped back to the tensors (or the scratch offsets)
    they came from."""

    def __init__(self, monkeypatch, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.calls = []
        monkeypatch.setattr(kernels, "_all_cpu", lambda *ts: False)
        monkeypatch.setattr(kernels, "_check_cuda", lambda *a: None)
        monkeypatch.setattr(kernels, "_launch", self.launch)
        real_empty = torch.empty
        monkeypatch.setattr(torch, "empty", lambda *a, **k: self.track(real_empty(*a, **k)))

    def track(self, t):
        self.by_ptr[t.data_ptr()] = t
        return t

    def launch(self, name, *args):
        self.calls.append((name, args))
        getattr(self, name)(*args)

    def hamming_best_two_projection(self, d1, uv1, v1, radius, radius_scalar, lev1, n, d2,
                                    uv2, v2, lev2, m, col_base, seeded, slack, idx, best,
                                    second):
        assert 1 <= m <= kernels.PROJ_CHUNK
        t = {k: self.by_ptr[p] for k, p in (("mp_desc", d1), ("proj_uv", uv1),
                                            ("proj_valid", v1), ("pred_level", lev1),
                                            ("feat_desc", d2), ("feat_uv", uv2),
                                            ("feat_valid", v2), ("feat_level", lev2))}
        t["radius"] = self.by_ptr[radius] if radius is not None else radius_scalar
        for k in ("feat_desc", "feat_uv", "feat_valid", "feat_level"):
            t[k] = t[k][col_base:col_base + m]
        got = kernels.hamming_best_two_projection_ref(**t, level_slack=slack)
        out = [self.by_ptr[idx], self.by_ptr[best], self.by_ptr[second]]
        for i in range(n):
            part = (int(got[1][i]), int(got[0][i]) + col_base, int(got[2][i]))
            if seeded:
                part = kernels.stat_merge((int(out[1][i]), int(out[0][i]), int(out[2][i])),
                                          part)
            out[1][i], out[0][i], out[2][i] = part

    def hamming_best_two_valid(self, d1, v1, n, d2, v2, m, idx, best, second, col_key,
                               counts, row_list, col_list, tile_done, part):
        scratch = next(t for p, t in self.by_ptr.items()
                       if t.dtype == torch.int32 and p == counts)
        assert (row_list - counts, col_list - counts, tile_done - counts) == (
            8, 4 * (2 + n), 4 * (2 + n + m))
        assert (part - counts) % 16 == 0 and part - counts >= 4 * (2 + n + m + -(-n // 128))
        assert scratch.numel() * 4 - (part - counts) == 16 * kernels.VALID_MAX_SPLITS * n
        got = kernels.hamming_best_two_valid_compacted_ref(
            self.by_ptr[d1], self.by_ptr[v1], self.by_ptr[d2], self.by_ptr[v2])
        self.by_ptr[idx].copy_(got[0])
        self.by_ptr[best].copy_(got[1])
        self.by_ptr[second].copy_(got[2])
        self.by_ptr[col_key].copy_((torch.full_like(got[3], 7) << 32) | got[3])


@pytest.mark.parametrize("m", [1024, 4608, kernels.PROJ_CHUNK + 3])
def test_projection_wrapper_launches_seeded_chunks(monkeypatch, m):
    """One launch up to PROJ_CHUNK columns, one a chunk beyond in column
    order, the first unseeded and the rest seeded; the outputs after the
    last launch equal the plain version on the whole column set."""
    rng = np.random.RandomState(m)
    t = _to_torch(_proj_case(rng, 40, m))
    fake = _FakeCard(monkeypatch, [v for v in t.values() if isinstance(v, torch.Tensor)])
    got = kernels.hamming_best_two_projection(**t)
    monkeypatch.undo()
    chunks = kernels.projection_chunks(m)
    assert [(a[11], a[12], a[13]) for _, a in fake.calls] == [
        (hi - lo, lo, int(lo > 0)) for lo, hi in chunks]
    want = kernels.hamming_best_two_projection_ref(**t)
    for g, w, what in zip(got, want, ("idx", "best", "second")):
        assert g.dtype == w.dtype and torch.equal(g, w), what


def test_validity_wrapper_is_one_launch_with_its_scratch(monkeypatch):
    """One launch a call, its scratch laid out as csrc/hamming_mma.cu reads
    it, the column keys' low words returned as the argmin rows."""
    rng = np.random.RandomState(37)
    t = [torch.from_numpy(a) for a in _valid_case(rng, 300, 200)]
    fake = _FakeCard(monkeypatch, t)
    got = kernels.hamming_best_two_valid(*t)
    monkeypatch.undo()
    assert [name for name, _ in fake.calls] == ["hamming_best_two_valid"]
    want = kernels.hamming_best_two_valid_ref(*t)
    for g, w, what in zip(got, want, ("idx", "best", "second", "argmin_row")):
        assert g.dtype == w.dtype and torch.equal(g, w), what


def _cu_constants(name):
    """The constexpr ints and floats at the top level of csrc/<name>, each
    evaluated over the ones before it."""
    import re
    src = (kernels.CSRC / name).read_text()
    out = {}
    for ty, key, expr in re.findall(
            r"^constexpr (int|float|unsigned) (\w+) = ([^;]+);", src, re.M):
        expr = re.sub(r"\b(0x[0-9a-fA-F]+)[uU]\b", r"\1", expr)
        expr = re.sub(r"\b(\d+(?:\.\d*)?)[uUfF]\b", r"\1", expr)
        if ty != "float":
            expr = expr.replace("/", "//")
        try:
            out[key] = eval(expr, {}, dict(out))
        except NameError:            # INT_MIN and the like: not a design constant
            pass
    return out


@pytest.mark.parametrize("model,source,expr", [
    ("PROJ_CHUNK", "hamming.cu", "PG_MAX_M"),
    ("PROJ_CELL", "hamming.cu", "1.0 / PG_INV_CELL"),
    ("PROJ_MAX_CELLS", "hamming.cu", "PG_MAX_CELLS"),
    ("PROJ_LIMIT", "hamming.cu", "PG_LIMIT"),
    ("VALID_ROWS", "hamming_mma.cu", "VC_ROWS"),
    ("VALID_CHUNK", "hamming_mma.cu", "VC_CHUNK"),
    ("VALID_MAX_SPLITS", "hamming_mma.cu", "VC_MAX_SPLITS"),
])
def test_model_constants_are_the_kernels_own(model, source, expr):
    """The CPU models and the wrappers take each design constant from
    kernels.py; the kernels hold their own in csrc/. Both must agree."""
    assert getattr(kernels, model) == eval(expr, {}, _cu_constants(source))
