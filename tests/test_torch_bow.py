"""Bag-of-words place recognition of the PyTorch port (vocabulary tree,
keyframe database) against the JAX package, on the CPU, from the same
numpy inputs: word ids exactly, tf-idf vectors and scores within 1e-6 and
1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu import config as cfg
from multi_orbslam3_tpu.bow import database as jdb
from multi_orbslam3_tpu.bow import vocabulary as jvoc
from multi_orbslam3_tpu.dataio import synthetic
from multi_orbslam3_tpu.frontend import extractor as jex
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.bow import database as tdb
from multi_orbslam3_tpu_torch.bow import vocabulary as tvoc


def words_i32(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32))


@pytest.fixture(scope="module")
def vocs():
    """The bundled k=10 L=5 vocabulary, loaded by each package."""
    return jvoc.default_vocabulary(10, 5), tvoc.default_vocabulary(10, 5, device="cpu")


@pytest.fixture(scope="module")
def descs():
    """A rendered frame's descriptors (extracted by the JAX package) and
    random words with the top bit set in every word."""
    c = cfg.small_synthetic()
    seq = synthetic.make_sequence(c, n_frames=1, n_points=500, seed=7,
                                  trajectory="forward")
    img = np.clip(np.round(seq.images[0]), 0, 255).astype(np.float32)
    f = jex.extract_features(jnp.asarray(img), c)
    rng = np.random.RandomState(0)
    rand = rng.randint(0, 2 ** 31, (64, 8), dtype=np.int64).astype(np.uint32) | np.uint32(1 << 31)
    return np.concatenate([np.asarray(f.desc), rand]), \
        np.concatenate([np.asarray(f.valid), np.ones(64, bool)])


def test_bundled_vocabulary_matches_the_jax_load(vocs):
    jv, tv = vocs
    assert (tv.branching, tv.depth, tv.n_words) == (jv.branching, jv.depth, 100_000)
    for a, b in zip(jv.levels, tv.levels):
        np.testing.assert_array_equal(b.numpy().view(np.uint32), np.asarray(a))
    np.testing.assert_array_equal(tv.idf.numpy(), np.asarray(jv.idf))
    carried = interop.vocabulary_from_numpy([np.asarray(a) for a in jv.levels],
                                            np.asarray(jv.idf), 10, 5)
    for a, b in zip(carried.levels, tv.levels):
        assert torch.equal(a, b)


def test_assign_words_exact_on_l5(vocs, descs):
    jv, tv = vocs
    d, valid = descs
    want = np.asarray(jvoc.assign_words(jv, jnp.asarray(d), jnp.asarray(valid)))
    got = tvoc.assign_words(tv, words_i32(d), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[valid] >= 0).all() and (want[~valid] == -1).all()
    assert len(np.unique(want[valid])) > 50


def test_bow_vector_within_1e_6(vocs, descs):
    jv, tv = vocs
    d, valid = descs
    w = jvoc.assign_words(jv, jnp.asarray(d), jnp.asarray(valid))
    want = np.asarray(jvoc.bow_vector(jv, w))
    got = tvoc.bow_vector(tv, torch.from_numpy(np.array(w))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert abs(np.linalg.norm(got) - 1.0) < 1e-5


def test_train_vocabulary_random_bits_matches_jax():
    """The random-bit fallback at the small config's shape (k=6, L=3):
    level tables exactly, idf within 1e-6."""
    jv = jvoc.default_vocabulary(6, 3)
    tv = tvoc.default_vocabulary(6, 3, device="cpu")
    assert tv.n_words == jv.n_words == 216
    for a, b in zip(jv.levels, tv.levels):
        np.testing.assert_array_equal(b.numpy().view(np.uint32), np.asarray(a))
    np.testing.assert_allclose(tv.idf.numpy(), np.asarray(jv.idf), atol=1e-6, rtol=0)


def db_np(db):
    return {f: np.asarray(getattr(db, f)) for f in jdb.KeyframeDatabase._fields}


def assert_db_match(db_t, db_j):
    got, want = interop.database_to_numpy(db_t), db_np(db_j)
    for f in want:
        if want[f].dtype.kind == "f":
            np.testing.assert_allclose(got[f], want[f], atol=1e-5, rtol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_database_add_batch_erase_query_match_jax(vocs):
    """Single and batched inserts, an erase and queries (with and without
    an exclusion mask): the tables equal, scores within 1e-5, the same
    argmax."""
    jv, tv = vocs
    rng = np.random.RandomState(5)
    max_kf, n = 16, 64
    desc = rng.randint(0, 2 ** 32, (8, n, 8), dtype=np.uint64).astype(np.uint32)
    valid = rng.rand(8, n) < 0.9
    dj = jdb.KeyframeDatabase.empty(max_kf, jv.n_words)
    dt = tdb.KeyframeDatabase.empty(max_kf, device="cpu")
    for k in range(4):
        dj, wj = jdb.add_keyframe_bow(dj, jv, jnp.int32(k), jnp.asarray(desc[k]),
                                      jnp.asarray(valid[k]), agent=k % 2)
        dt, wt = tdb.add_keyframe_bow(dt, tv, k, words_i32(desc[k]),
                                      torch.from_numpy(valid[k]), agent=k % 2)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    slots = np.array([4, -1, 6, 7], np.int32)
    agents = np.array([1, 0, 1, 0], np.int32)
    dj = jdb.add_keyframes_bow_batch(dj, jv, jnp.asarray(slots), jnp.asarray(desc[4:]),
                                     jnp.asarray(valid[4:]), jnp.asarray(agents))
    dt = tdb.add_keyframes_bow_batch(dt, tv, torch.from_numpy(slots), words_i32(desc[4:]),
                                     torch.from_numpy(valid[4:]), torch.from_numpy(agents))
    assert_db_match(dt, dj)
    dj, dt = jdb.erase_keyframe_bow(dj, jnp.int32(2)), tdb.erase_keyframe_bow(dt, 2)
    assert_db_match(dt, dj)
    # query with a noisy copy of keyframe 3's descriptors
    noisy = desc[3] ^ (rng.rand(n, 8) < 0.02).astype(np.uint32)
    for excl in (np.zeros(max_kf, bool), np.arange(max_kf) == 3):
        sj = np.asarray(jdb.query(dj, jv, jnp.asarray(noisy), jnp.asarray(valid[3]),
                                  jnp.asarray(excl)))
        st = tdb.query(dt, tv, words_i32(noisy), torch.from_numpy(valid[3]),
                       torch.from_numpy(excl)).numpy()
        np.testing.assert_allclose(st, sj, atol=1e-5, rtol=0)
        assert int(np.argmax(st)) == int(np.argmax(sj))
    assert int(np.argmax(st)) != 3 and st[2] == 0.0 and st[3] == 0.0


def test_query_vector_matches_query_and_rejects_a_missing_voc(vocs):
    """query_vector equals query on the same frame; the JAX package's
    positional ``voc`` trap (a caller passing (db, v, exclude)) raises a
    TypeError here."""
    _, tv = vocs
    rng = np.random.RandomState(6)
    d = words_i32(rng.randint(0, 2 ** 32, (64, 8), dtype=np.uint64).astype(np.uint32))
    ok = torch.ones(64, dtype=torch.bool)
    db, w = tdb.add_keyframe_bow(tdb.KeyframeDatabase.empty(8, device="cpu"), tv, 1, d, ok)
    excl = torch.zeros(8, dtype=torch.bool)
    v = tvoc.bow_vector(tv, w)
    assert torch.equal(tdb.query_vector(db, tv, v, excl), tdb.query(db, tv, d, ok, excl))
    with pytest.raises(TypeError):
        tdb.query_vector(db, v, excl, excl)
