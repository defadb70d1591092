"""The two kernels' launch caps, on the CPU: K1 takes at most
kernels.MAX_LEVELS levels a launch and the stereo match at most
kernels.STEREO_CHUNK right features a launch; the wrappers cover any count
with several launches. Here:

- the grouping of levels and of right-feature chunks covers every index
  once, in order, with one launch up to the cap;
- each wrapper's CUDA path (its launches, their arguments and the seeding
  of a chunk by the chunks before it) driven through a stand-in for the
  kernel launch that computes what the kernel computes, against the plain
  versions;
- the chunked CPU model of the stereo row-band search against the plain
  version and the JAX package's stereo match at 4,097 and 8,192 right
  features, with ties across a chunk border;
- extract_features_pair at 9 levels (18 levels, two K1 launches on a card)
  against the JAX package's two extractions;
- the stereo row tolerance at levels 32-40 against the JAX package's
  row_tol * 1.2**level.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu import config as jcfg
from multi_orbslam3_tpu.dataio import synthetic as jsynthetic
from multi_orbslam3_tpu.frontend import extractor as jex
from multi_orbslam3_tpu.frontend import matcher as jmatcher
from multi_orbslam3_tpu.frontend import stereo as jstereo
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.frontend import extractor as tex
from multi_orbslam3_tpu_torch.frontend import kernels
from multi_orbslam3_tpu_torch.frontend import stereo as tstereo

torch.set_num_threads(2)

BIG = kernels.BIG
F32 = np.float32


def _words(rng, n):
    return rng.randint(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64).astype(np.int32)


# ----------------------------------------------------------------------
# the grouping
# ----------------------------------------------------------------------

def test_level_groups_cover_1_to_40_levels_once():
    for n in range(1, 41):
        groups = kernels.even_groups(n, kernels.MAX_LEVELS)
        covered = [i for lo, hi in groups for i in range(lo, hi)]
        assert covered == list(range(n)), n
        assert all(0 < hi - lo <= kernels.MAX_LEVELS for lo, hi in groups)
        assert len(groups) == -(-n // kernels.MAX_LEVELS)
    assert kernels.even_groups(0, kernels.MAX_LEVELS) == []
    assert kernels.even_groups(18, kernels.MAX_LEVELS) == [(0, 9), (9, 18)]


def test_stereo_chunks_cover_every_column_once():
    for m in (1, 77, 1024, 4095, 4096, 4097, 4608, 8191, 8192, 8193, 12288, 20000):
        chunks = kernels.stereo_chunks(m)
        assert [j for lo, hi in chunks for j in range(lo, hi)] == list(range(m)), m
        assert all(hi - lo == kernels.STEREO_CHUNK for lo, hi in chunks[:-1])
        assert 0 < chunks[-1][1] - chunks[-1][0] <= kernels.STEREO_CHUNK
        assert len(chunks) == -(-m // kernels.STEREO_CHUNK)
    assert kernels.stereo_chunks(4096) == [(0, 4096)]


# ----------------------------------------------------------------------
# the wrappers' CUDA paths, with the launch computed on the CPU
# ----------------------------------------------------------------------

class _FakeCard:
    """Stands in for the device in a wrapper: every tensor counts as a CUDA
    tensor, and a launch is computed on the CPU from the same arguments the
    C entry receives (pointers mapped back to the tensors they came from)."""

    def __init__(self, monkeypatch, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.calls = []
        monkeypatch.setattr(kernels, "_all_cpu", lambda *ts: False)
        monkeypatch.setattr(kernels, "_check_cuda", lambda *a: None)
        monkeypatch.setattr(kernels, "_launch", self.launch)

    def track(self, t):
        self.by_ptr[t.data_ptr()] = t
        return t

    def launch(self, name, *args):
        self.calls.append((name, args))
        getattr(self, name)(*args)

    def fast_score_nms_levels(self, ins, outs, hs, ws, n, threshold):
        assert 1 <= n <= kernels.MAX_LEVELS
        for k in range(n):
            src = self.by_ptr[ins[k]]
            assert tuple(src.shape) == (hs[k], ws[k])
            self.outs.append((outs[k], kernels.fast_score_nms_ref(src, threshold)))

    def hamming_best_two_stereo(self, d1, uv1, v1, tol, lev1, n, d2, uv2, v2, lev2, m,
                                col_base, seeded, dmin, dmax, slack, idx, best, second):
        assert 1 <= m <= kernels.STEREO_CHUNK
        t = {k: self.by_ptr[p] for k, p in (("descL", d1), ("uvL", uv1), ("validL", v1),
                                            ("tol", tol), ("levelL", lev1), ("descR", d2),
                                            ("uvR", uv2), ("validR", v2), ("levelR", lev2))}
        for k in ("descR", "uvR", "validR", "levelR"):
            t[k] = t[k][col_base:col_base + m]
        got = kernels.hamming_best_two_stereo_ref(**t, max_disparity=dmax)
        out = [self.by_ptr[idx], self.by_ptr[best], self.by_ptr[second]]
        for i in range(n):
            chunk = (int(got[1][i]), int(got[0][i]) + col_base, int(got[2][i]))
            if seeded:
                chunk = kernels.stat_merge(
                    (int(out[1][i]), int(out[0][i]), int(out[2][i])), chunk)
            out[1][i], out[0][i], out[2][i] = chunk


@pytest.mark.parametrize("n_levels", [1, 8, 16, 17, 18, 24, 40])
def test_k1_wrapper_launches_groups_into_one_buffer(monkeypatch, n_levels):
    """Every level goes to exactly one launch of at most MAX_LEVELS levels,
    in order, as a view of one output buffer; one launch up to the cap."""
    rng = np.random.RandomState(n_levels)
    levels = [torch.from_numpy(np.round(rng.uniform(0, 255, (9 + k % 5, 12 + k % 7)))
                               .astype(F32)) for k in range(n_levels)]
    fake = _FakeCard(monkeypatch, levels)
    fake.outs = []
    got = kernels.fast_score_nms_levels(levels, 7.0)
    assert len(fake.calls) == len(kernels.even_groups(n_levels, kernels.MAX_LEVELS))
    assert len(fake.calls) == (1 if n_levels <= kernels.MAX_LEVELS else
                               -(-n_levels // kernels.MAX_LEVELS))
    sent = [p for _, (ins, *_rest) in fake.calls for p in ins]
    assert sent == [im.data_ptr() for im in levels]
    assert [p for p, _ in fake.outs] == [g.data_ptr() for g in got]
    base = got[0].untyped_storage().data_ptr()
    assert all(g.untyped_storage().data_ptr() == base for g in got)
    for g, (_, want) in zip(got, fake.outs):
        g.copy_(want)
    for g, want in zip(got, kernels.fast_score_nms_levels_ref(levels, 7.0)):
        assert torch.equal(g, want)


def _stereo_inputs(rng, n, m, tie_at=None):
    """Left rows near the right columns they copy (as in
    tests/test_torch_k2_redesign.py); with tie_at, right columns tie_at - 1
    and tie_at hold one descriptor on one image row and a share of the left
    rows copy it, so that the first tied column lies in one chunk and the
    second in the next."""
    dR = _words(rng, m)
    src = rng.randint(0, m, n)
    dL = np.where((rng.rand(n) < 0.6)[:, None], dR[src], _words(rng, n))
    uvR = np.stack([np.round(rng.uniform(0, 752, m)), np.round(rng.uniform(0, 479, m))],
                   1).astype(F32)
    levelR = rng.randint(0, 8, m).astype(np.int32)
    uvL = (uvR[src] + np.stack([rng.uniform(-5, 140, n), rng.randn(n) * 3.0], 1)).astype(F32)
    levelL = np.clip(levelR[src] + rng.randint(-2, 3, n), 0, 7).astype(np.int32)
    validL, validR = rng.rand(n) < 0.8, rng.rand(m) < 0.8
    rows = None
    if tie_at is not None:
        pair = np.array([tie_at - 1, tie_at])
        dR[pair] = dR[tie_at - 1]
        uvR[pair] = np.array([[300.0, 200.0], [301.0, 200.0]], F32)
        levelR[pair] = 2
        validR[pair] = True
        rows = np.arange(0, n, 9)
        dL[rows] = dR[tie_at - 1]
        uvL[rows] = np.array([340.0, 200.5], F32)
        levelL[rows] = 2
        validL[rows] = True
    c = dict(descL=dL, uvL=uvL, validL=validL, levelL=levelL, descR=dR, uvR=uvR,
             validR=validR, levelR=levelR)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items()}
    t["tol"] = kernels.stereo_row_tolerance(t["levelL"], 2.0)
    return c, t, rows


@pytest.mark.parametrize("m", [1024, 4096, 4097, 8192])
def test_stereo_wrapper_launches_seeded_chunks(monkeypatch, m):
    """The wrapper's CUDA path: one launch a chunk, in column order, the
    first unseeded and the rest seeded; the outputs after the last launch
    equal the plain version on the whole right set."""
    chunks = kernels.stereo_chunks(m)
    rng = np.random.RandomState(m)
    c, t, rows = _stereo_inputs(rng, 200, m, tie_at=chunks[-1][0] if len(chunks) > 1 else None)
    fake = _FakeCard(monkeypatch, list(t.values()))
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: fake.track(real_empty(*a, **k)))
    got = kernels.hamming_best_two_stereo(**t, max_disparity=128.0)
    monkeypatch.undo()
    assert [(a[10], a[11], a[12]) for _, a in fake.calls] == [
        (hi - lo, lo, int(lo > 0)) for lo, hi in chunks]
    want = kernels.hamming_best_two_stereo_ref(**t, max_disparity=128.0)
    for g, w, what in zip(got, want, ("idx", "best", "second")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
    if rows is not None:
        assert (got[0][rows] == chunks[-1][0] - 1).all()
        assert (got[1][rows] == 0).all() and (got[2][rows] == 0).all()


# ----------------------------------------------------------------------
# the chunked CPU model against the plain version and JAX
# ----------------------------------------------------------------------

def _jax_best_two(c, max_disparity=128.0):
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
    return tuple(np.asarray(x) for x in jmatcher._best_two(dist))


@pytest.mark.parametrize("m", [4097, 8192])
def test_chunked_banded_model_equals_plain_and_jax(m):
    """Ties across a chunk border: the first tied column lies in the
    earlier chunk, which the model visits last; the (distance, column)
    merge gives it, with second == best."""
    chunks = kernels.stereo_chunks(m)
    assert len(chunks) == 2
    border = chunks[1][0]
    c, t, rows = _stereo_inputs(np.random.RandomState(m + 1), 256, m, tie_at=border)
    got = kernels.hamming_best_two_stereo_banded_ref(**t, max_disparity=128.0)
    want = kernels.hamming_best_two_stereo_ref(**t, max_disparity=128.0)
    for g, w, what in zip(got, want, ("idx", "best", "second")):
        assert g.dtype == w.dtype and torch.equal(g, w), what
    for g, j in zip(got, _jax_best_two(c)):
        np.testing.assert_array_equal(g.numpy(), j)
    np.testing.assert_array_equal(got[0].numpy()[rows], border - 1)
    np.testing.assert_array_equal(got[2].numpy()[rows], 0)
    assert int((got[1] < BIG).sum()) > 100
    if m - border >= 1024:                              # matches in both chunks
        assert int((got[0] >= border).sum()) > 20


def test_chunked_stereo_match_equals_jax_stereo_match(monkeypatch):
    """frontend/stereo.py::stereo_match at 8,192 right features with the
    chunked banded model in place of the fused match gives the JAX
    package's stereo_match: valid and u_right exactly, the depth to 1e-5
    relative (XLA's CPU division, as in tests/test_torch_stereo.py)."""
    m = 8192
    c, t, _ = _stereo_inputs(np.random.RandomState(3), 256, m,
                             tie_at=kernels.stereo_chunks(m)[1][0])

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


# ----------------------------------------------------------------------
# the stereo pair at 9 levels, and the tolerance above level 31
# ----------------------------------------------------------------------

def _pair_config(cfg):
    c = cfg.synthetic_mono(width=320, height=240)
    return c.replace(
        sensor="stereo",
        camera=cfg.CameraConfig(width=320, height=240, fx=400.0, fy=400.0,
                                cx=160.0, cy=120.0, baseline=0.2),
        orb=cfg.ORBConfig(n_features=384, n_levels=9))


def test_extract_features_pair_at_9_levels_equals_jax():
    """A 9-level pair is 18 levels, above one K1 launch: the pair equals
    two single extractions bit for bit, and each side the JAX package's
    extraction of its image: the same keypoints at the same (uv, level),
    the same descriptors, uv_und to 1e-3 (the measure of
    tests/test_torch_frontend.py::test_extraction_matches_jax)."""
    cj, ct = _pair_config(jcfg), _pair_config(tcfg)
    assert len(kernels.even_groups(2 * ct.orb.n_levels, kernels.MAX_LEVELS)) == 2
    seq = jsynthetic.make_sequence(cj, n_frames=3, n_points=500, seed=9,
                                   trajectory="forward")
    il, ir = (torch.from_numpy(np.array(a[2])) for a in (seq.images, seq.images_right))
    pair = tex.extract_features_pair(il, ir, ct)
    for got, img in zip(pair, (il, ir)):
        single = tex.extract_features(img, ct)
        for name in single._fields:
            assert torch.equal(getattr(got, name), getattr(single, name)), name
        fj = {k: np.asarray(v) for k, v in
              jex.extract_features(jnp.asarray(img.numpy()), cj)._asdict().items()}
        ft = interop.features_to_numpy(got)
        key_j = {(float(u), float(v), int(lv)): i for i, ((u, v), lv, ok) in
                 enumerate(zip(fj["uv"], fj["level"], fj["valid"])) if ok}
        key_t = {(float(u), float(v), int(lv)): i for i, ((u, v), lv, ok) in
                 enumerate(zip(ft["uv"], ft["level"], ft["valid"])) if ok}
        assert len(key_j) > 100 and int(fj["level"][fj["valid"]].max()) == 8
        assert set(key_t) == set(key_j)
        assert all(np.array_equal(fj["desc"][key_j[k]], ft["desc"][key_t[k]]) for k in key_j)
        np.testing.assert_allclose(ft["uv_und"], fj["uv_und"], atol=1e-3)


def test_stereo_row_tolerance_above_level_31_equals_jax():
    """row_tol * 1.2^level for levels 32-40 (the table held 32 levels and
    clamped the rest), and far up, where float32 overflows to inf."""
    levels = np.concatenate([np.arange(0, 41), [100, 300, 486, 487, 488, 600, 10_000]])
    for row_tol in (2.0, 1.5):
        got = kernels.stereo_row_tolerance(torch.from_numpy(levels.astype(np.int32)), row_tol)
        want = np.asarray(row_tol * jnp.power(1.2, jnp.asarray(levels, jnp.float32)))
        np.testing.assert_array_equal(got.numpy(), want)
    assert np.isinf(got.numpy()[-1])
