"""The two K2 kernels' redesigns, on the CPU: the forms their CUDA kernels
compute, against the plain versions and the JAX package.

- The matrix: csrc/hamming_mma.cu writes popc(a) + popc(b) - 2 popc(a & b);
  the library yardstick beside it in chip_smoke.py is cuBLASLt's int8
  product (torch._int_mm) on descriptors unpacked to +-1, which gives
  256 - 2 x the distance. Both forms equal JAX's matcher.hamming_matrix and
  the plain version exactly.
- The stereo match: csrc/stereo_band.cu indexes the right features by
  image row and visits, per left row, only the buckets of its row band, in
  an order that is not column order. kernels.stereo_band_candidates is that
  visit and kernels.hamming_best_two_stereo_banded_ref the search on it;
  it equals the plain version and the JAX package's stereo match on random
  cases, ties that arrive out of column order, pairs exactly on the row
  tolerance and the disparity limits, empty bands, rows at the image's
  first and last row, and right features past the index's reach.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from multi_orbslam3_tpu.frontend import extractor as jex
from multi_orbslam3_tpu.frontend import matcher as jmatcher
from multi_orbslam3_tpu.frontend import stereo as jstereo
from multi_orbslam3_tpu_torch.frontend import extractor as tex
from multi_orbslam3_tpu_torch.frontend import kernels
from multi_orbslam3_tpu_torch.frontend import stereo as tstereo

torch.set_num_threads(2)

BIG = kernels.BIG
F32 = np.float32


def _words(rng, n):
    return rng.randint(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64).astype(np.int32)


# ----------------------------------------------------------------------
# the matrix: the 1-bit identity and the +-1 int8 product
# ----------------------------------------------------------------------

def test_unpack_pm1_bit_order_and_the_sign_bit():
    """Element 32 w + b is +1 where bit b of word w is set (b = 31 the sign
    bit of a negative int32), else -1."""
    special = np.array([0, -1, -2 ** 31, 1, 2 ** 31 - 1, 0x40000000, -0x55555556, 12345],
                       dtype=np.int32)
    words = np.stack([np.roll(special, k) for k in range(5)]
                     + list(_words(np.random.RandomState(0), 11)))
    got = kernels.unpack_pm1(torch.from_numpy(words))
    assert got.dtype == torch.int8 and got.shape == (16, 256)
    bits = np.unpackbits(words.view(np.uint32).astype("<u4").view(np.uint8),
                         bitorder="little").reshape(16, 256)
    np.testing.assert_array_equal(got.numpy(), 2 * bits.astype(np.int8) - 1)
    assert got[0, 32 * 2 + 31] == 1 and got[0, 32 * 2 + 30] == -1     # -2^31
    assert (got[0, 32:64] == 1).all() and (got[0, :32] == -1).all()   # -1 and 0


@pytest.mark.parametrize("n,m", [(17, 8), (64, 40), (130, 24)])
def test_pm1_product_and_the_mma_identity_equal_jax(n, m):
    """(256 - a_pm1 @ b_pm1^T) / 2, by an int32 matrix product and by
    torch._int_mm (cuBLASLt's int8 product on the card; b as a transposed
    view, the layout it takes), and popc(a) + popc(b) - 2 popc(a & b), the
    matrix kernel's arithmetic, all equal JAX's hamming_matrix and the
    plain version exactly."""
    rng = np.random.RandomState(n + m)
    d1, d2 = _words(rng, n), _words(rng, m)
    d2[::5] = d1[:m][::5]                          # distance 0 on some pairs
    d2[1] = ~d1[1]                                 # and 256
    want = np.asarray(jmatcher.hamming_matrix(jnp.asarray(d1.view(np.uint32)),
                                              jnp.asarray(d2.view(np.uint32))))
    t1, t2 = torch.from_numpy(d1), torch.from_numpy(d2)
    ref = kernels.hamming_matrix_ref(t1, t2)
    np.testing.assert_array_equal(ref.numpy(), want)
    a, b = kernels.unpack_pm1(t1), kernels.unpack_pm1(t2)
    by_int32 = kernels.hamming_from_pm1_dot(a.to(torch.int32) @ b.to(torch.int32).T)
    by_int_mm = kernels.hamming_from_pm1_dot(torch._int_mm(a, b.t()))
    pop = lambda d: kernels.popcount32(d).sum(1, dtype=torch.int32)
    both = sum(kernels.popcount32(t1[:, None, w] & t2[None, :, w]) for w in range(8))
    identity = pop(t1)[:, None] + pop(t2)[None, :] - 2 * both
    for got in (by_int32, by_int_mm, identity):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == 0 and want.max() == 256


# ----------------------------------------------------------------------
# the stereo match: the row-band search's CPU model
# ----------------------------------------------------------------------

def _case(rng, n, m, height=480.0, width=752.0, keep=0.8, n_levels=8, copy=0.6):
    """Left features near the right ones they were made from (a random
    share copying their descriptor), both sets partly invalid."""
    dR = _words(rng, m)
    src = rng.randint(0, m, n)
    dL = np.where((rng.rand(n) < copy)[:, None], dR[src], _words(rng, n))
    uvR = np.stack([np.round(rng.uniform(0, width, m)),
                    np.round(rng.uniform(0, height - 1, m))], 1).astype(F32)
    levelR = rng.randint(0, n_levels, m).astype(np.int32)
    uvL = (uvR[src] + np.stack([rng.uniform(-5, 140, n), rng.randn(n) * 3.0], 1)).astype(F32)
    levelL = np.clip(levelR[src] + rng.randint(-2, 3, n), 0, n_levels - 1).astype(np.int32)
    return dict(descL=dL, uvL=uvL, validL=rng.rand(n) < keep, levelL=levelL,
                descR=dR, uvR=uvR, validR=rng.rand(m) < keep, levelR=levelR)


def _torch_args(c):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items()}
    t["tol"] = kernels.stereo_row_tolerance(t["levelL"], 2.0)
    return t


def _jax_best_two(c, max_disparity=128.0):
    """frontend/stereo.py's mask, spelled as stereo_match spells it, then
    matcher._best_two."""
    uvL, uvR = jnp.asarray(c["uvL"]), jnp.asarray(c["uvR"])
    levelL, levelR = jnp.asarray(c["levelL"]), jnp.asarray(c["levelR"])
    dv = jnp.abs(uvL[:, None, 1] - uvR[None, :, 1])
    disp = uvL[:, None, 0] - uvR[None, :, 0]
    tol = 2.0 * jnp.power(1.2, levelL.astype(jnp.float32))
    mask = (dv <= tol[:, None]) & (disp > 0.3) & (disp < max_disparity) \
        & (jnp.abs(levelL[:, None] - levelR[None, :]) <= 1) \
        & jnp.asarray(c["validL"])[:, None] & jnp.asarray(c["validR"])[None, :]
    dist = jnp.where(mask, jmatcher.hamming_matrix(jnp.asarray(c["descL"].view(np.uint32)),
                                                   jnp.asarray(c["descR"].view(np.uint32))),
                     jmatcher.BIG)
    return tuple(np.asarray(x) for x in jmatcher._best_two(dist)), np.asarray(mask)


def _check(c, jax_too=True, min_matched=1):
    """Banded model == plain version (== JAX); returns the model's result."""
    t = _torch_args(c)
    got = kernels.hamming_best_two_stereo_banded_ref(**t, max_disparity=128.0)
    want = kernels.hamming_best_two_stereo_ref(**t, max_disparity=128.0)
    for g, w, what in zip(got, want, ("idx", "best", "second")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
    if jax_too:
        (idx_j, best_j, second_j), _ = _jax_best_two(c)
        np.testing.assert_array_equal(got[0].numpy(), idx_j)
        np.testing.assert_array_equal(got[1].numpy(), best_j)
        np.testing.assert_array_equal(got[2].numpy(), second_j)
    assert int((got[1] < BIG).sum()) >= min_matched
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_banded_search_equals_plain_and_jax_on_random_cases(seed):
    rng = np.random.RandomState(seed)
    c = _case(rng, 300, 260)
    got = _check(c, min_matched=30)
    t = _torch_args(c)
    visited = sum(len(v) for v in kernels.stereo_band_candidates(
        t["uvL"], t["validL"], t["tol"], t["uvR"], t["validR"]))
    assert visited < 0.2 * 300 * 260                 # the band, not every column
    assert int((got[1] >= BIG).sum()) > 0


def test_banded_stereo_match_equals_jax_stereo_match(monkeypatch):
    """frontend/stereo.py::stereo_match with the banded model in place of
    the fused match gives the JAX package's stereo_match: valid and the
    matched right u exactly, the depth to 1e-5 relative (XLA's division on
    the CPU is 1 ulp off the IEEE quotient, as in tests/test_torch_stereo.py)."""
    rng = np.random.RandomState(5)
    c = _case(rng, 256, 256)

    def feats(side, pkg):
        n = c["desc" + side].shape[0]
        uv, z = c["uv" + side], np.zeros(n, F32)
        if pkg == "jax":
            return jex.FrameFeatures(
                uv=jnp.asarray(uv), uv_und=jnp.asarray(uv), response=jnp.asarray(z),
                level=jnp.asarray(c["level" + side]), angle=jnp.asarray(z),
                desc=jnp.asarray(c["desc" + side].view(np.uint32)),
                valid=jnp.asarray(c["valid" + side]))
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        return tex.FrameFeatures(uv=to(uv), uv_und=to(uv), response=to(z),
                                 level=to(c["level" + side]), angle=to(z),
                                 desc=to(c["desc" + side]), valid=to(c["valid" + side]))

    want = jstereo.stereo_match(feats("L", "jax"), feats("R", "jax"), jnp.float32(50.0))
    monkeypatch.setattr(kernels, "hamming_best_two_stereo",
                        kernels.hamming_best_two_stereo_banded_ref)
    got = tstereo.stereo_match(feats("L", "torch"), feats("R", "torch"), 50.0)
    assert int(got.valid.sum()) > 20
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.u_right.numpy(), np.asarray(want.u_right))
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-5)


def test_banded_search_on_ties_out_of_column_order():
    """Several right columns share one descriptor on one image row: the
    bucket hands them to the search in descending column order, so a rule
    that keeps the first one seen would pick the wrong column; the banded
    search compares (distance, column) and gives the first column, with
    second == best."""
    rng = np.random.RandomState(7)
    c = _case(rng, 120, 90)
    dup = np.array([10, 30, 31, 55, 80])
    c["descR"][dup] = c["descR"][10]
    c["uvR"][dup, 1] = F32(200.0)
    c["uvR"][dup, 0] = F32(100.0) + np.arange(5, dtype=F32)
    c["levelR"][dup] = 3
    c["validR"][dup] = True
    rows = np.arange(0, 120, 6)
    c["descL"][rows] = c["descR"][10]
    c["uvL"][rows] = np.array([180.0, 200.5], F32)
    c["levelL"][rows] = 3
    c["validL"][rows] = True
    got = _check(c)
    np.testing.assert_array_equal(got[0].numpy()[rows], 10)
    np.testing.assert_array_equal(got[1].numpy()[rows], 0)
    np.testing.assert_array_equal(got[2].numpy()[rows], 0)
    # the trap is live: within the band, a higher tied column comes first
    t = _torch_args(c)
    order = kernels.stereo_band_candidates(t["uvL"], t["validL"], t["tol"], t["uvR"],
                                           t["validR"])[rows[0]]
    pos = {int(j): k for k, j in enumerate(order)}
    assert pos[80] < pos[55] < pos[31] < pos[30] < pos[10]


def test_banded_search_on_the_tolerance_and_disparity_limits():
    """Pairs exactly on the row tolerance of each level (inside), one
    float32 step beyond it (outside), at disparity exactly 0.3 and 128
    (outside) and one step inside each, at level gaps 1 and 2, with the
    exact differences of tests/test_torch_stereo.py's case, several pairs
    sharing a bucket."""
    n_levels, rows = 8, []
    for lv in range(n_levels):
        tol = F32(2.0) * F32(np.float64(F32(1.2)) ** lv)
        for dv in (tol, np.nextafter(tol, F32(np.inf)), -tol, np.nextafter(-tol, F32(-np.inf))):
            rows.append((lv, dv, F32(40.0), lv))
    for disp in (F32(0.3), np.nextafter(F32(0.3), F32(1)), F32(128.0),
                 np.nextafter(F32(128.0), F32(0))):
        rows.append((1, F32(0.0), disp, 1))
    for gap in (1, 2, -1, -2):
        rows.append((3, F32(0.0), F32(40.0), 3 + gap))
    n = len(rows)
    k = np.arange(n)
    is_disp = (k >= 4 * n_levels) & (k < 4 * n_levels + 4)
    dv = np.array([r[1] for r in rows], F32)
    disp = np.array([r[2] for r in rows], F32)
    uR = np.where(is_disp, 0.0, 1000.0 * k).astype(F32)
    vL = np.where(is_disp, 5000.0 + 100.0 * k, 0.0).astype(F32)
    c = dict(descL=_words(np.random.RandomState(4), n),
             uvL=np.stack([np.where(is_disp, disp, uR + disp), vL], 1).astype(F32),
             validL=np.ones(n, bool), levelL=np.array([r[0] for r in rows], np.int32),
             uvR=np.stack([uR, np.where(is_disp, vL, dv)], 1).astype(F32),
             validR=np.ones(n, bool), levelR=np.array([r[3] for r in rows], np.int32))
    c["descR"] = c["descL"].copy()
    got = _check(c)
    want = [True, False, True, False] * n_levels + [False, True, False, True] \
        + [True, False, True, False]
    np.testing.assert_array_equal((got[1].numpy() == 0), want)


def test_banded_search_on_empty_bands_and_the_image_edges():
    """Left rows at image rows 0 and H - 1 with right features there (the
    band reaches past the image; one pair passes only through rounding, a
    row below the band's exact edge), left rows whose band holds no right
    feature, a right set with nothing valid, and one with nothing at all in
    reach: (0, BIG, BIG) wherever nothing passes."""
    H = 480
    rng = np.random.RandomState(11)
    c = _case(rng, 64, 64, height=H)
    c["uvR"][:8, 1] = 0.0
    c["uvR"][8:16, 1] = F32(H - 1)
    c["uvL"][:8] = c["uvR"][:8] + np.array([20.0, 0.0], F32)
    c["uvL"][8:16] = c["uvR"][8:16] + np.array([20.0, -1.5], F32)
    c["descL"][:16] = c["descR"][:16]
    c["levelL"][:16] = c["levelR"][:16]
    c["validL"][:16] = True
    c["validR"][:16] = True
    c["uvR"][16:24, 1] = np.clip(c["uvR"][16:24, 1], 0, 300)
    c["uvL"][40:48, 1] = F32(400.5)                 # a band with no right row
    c["uvR"][np.abs(c["uvR"][:, 1] - 400.5) < 12, 1] = F32(10.0)
    # just above the first row: fl(tol - vR) rounds to tol, so the pair
    # passes, while floor(vR) = -1 lies one row below floor(vL - tol) = 0:
    # the band's spare row holds it
    c["uvR"][0, 1] = F32(-1e-8)
    c["uvL"][0, 1] = kernels.stereo_row_tolerance(torch.tensor(c["levelL"][:1]), 2.0).numpy()[0]
    got = _check(c)
    np.testing.assert_array_equal(got[1].numpy()[:16], 0)
    np.testing.assert_array_equal(got[1].numpy()[40:48], BIG)
    np.testing.assert_array_equal(got[0].numpy()[40:48], 0)
    nothing = dict(c, validR=np.zeros(64, bool))
    got = _check(nothing, min_matched=0)
    assert (got[1] == BIG).all() and (got[2] == BIG).all() and (got[0] == 0).all()
    far = dict(c, uvL=(c["uvL"] + np.array([0.0, 3000.0], F32)).astype(F32))
    got = _check(far, min_matched=0)
    assert (got[1] == BIG).all()


def test_banded_search_past_the_index_reach():
    """Right features at |v| >= 2^20, at inf and NaN go to the overflow
    bucket that every row scans; rows spread over more image rows than the
    index holds push the far ones there too; left rows at NaN or far out
    scan every bucket. The plain version decides all of them the same way
    (no JAX here: the plain float32 mask is JAX's, checked above)."""
    rng = np.random.RandomState(13)
    c = _case(rng, 200, 150, height=6000.0)          # > STEREO_MAX_BUCKETS rows
    c["uvR"][:6, 1] = np.array([2.0 ** 20, -2.0 ** 21, np.inf, -np.inf, np.nan, 5.0e6], F32)
    c["validR"][:6] = True
    c["uvL"][:6, 1] = c["uvR"][:6, 1]
    c["uvL"][6, 1] = np.nan
    c["uvL"][7, 1] = F32(2.0 ** 21)
    c["descL"][:8] = c["descR"][:8]
    t = _torch_args(c)
    cands = kernels.stereo_band_candidates(t["uvL"], t["validL"], t["tol"], t["uvR"],
                                           t["validR"])
    overflow = set(np.flatnonzero(c["validR"] & ~(np.abs(c["uvR"][:, 1]) < 2 ** 20)))
    assert overflow >= {0, 1, 2, 3, 4, 5} and all(overflow <= set(v) for v, ok in
                                                   zip(cands, c["validL"]) if ok)
    keys = np.floor(c["uvR"][c["validR"], 1][np.abs(c["uvR"][c["validR"], 1]) < 2 ** 20])
    assert keys.max() - keys.min() + 1 > kernels.STEREO_MAX_BUCKETS
    got = _check(c, jax_too=False, min_matched=20)
    assert int(got[1][0]) == 0 and int(got[1][5]) == 0      # found in the overflow bucket


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 90), m=st.integers(1, 90),
       height=st.sampled_from([3.0, 40.0, 480.0]), keep=st.sampled_from([0.3, 0.9, 1.0]),
       copy=st.sampled_from([0.0, 0.6, 1.0]))
def test_banded_search_equals_plain_hypothesis(seed, n, m, height, keep, copy):
    """Random shapes, densities and image heights (3 rows: every pair in
    a handful of buckets, duplicated descriptors common)."""
    rng = np.random.RandomState(seed)
    c = _case(rng, n, m, height=height, keep=keep, copy=copy)
    if copy == 1.0:
        c["descR"][rng.randint(0, m, m)] = c["descR"][0]     # many ties
    _check(c, jax_too=False, min_matched=0)
