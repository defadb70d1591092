"""Loop closing of the PyTorch port against the JAX package, on the CPU:
the hand-built maps of tests/test_loop.py are made by the JAX package and
carried across with interop, then both packages' covisibility, Atlas
merge, essential-graph correction, verification cascade, candidate
selection, place-recognition step and essential-graph audit run on them.
Deterministic stages must agree exactly or to the stated tolerance;
RANSAC stages reach the same decisions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.bow import vocabulary as jvoc
from multi_orbslam3_tpu.frontend.extractor import FrameFeatures
from multi_orbslam3_tpu.geometry import camera as jcam
from multi_orbslam3_tpu.geometry import se3 as jse3
from multi_orbslam3_tpu.geometry import sim3 as jsim3
from multi_orbslam3_tpu.map import audit as jaudit
from multi_orbslam3_tpu.map import mapstate as jms
from multi_orbslam3_tpu.pipeline import loop_closing as jlc
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.bow import vocabulary as tvoc
from multi_orbslam3_tpu_torch.geometry import camera as tcam
from multi_orbslam3_tpu_torch.geometry import sim3 as tsim3
from multi_orbslam3_tpu_torch.map import audit as taudit
from multi_orbslam3_tpu_torch.map import mapstate as tms
from multi_orbslam3_tpu_torch.pipeline import loop_closing as tlc

KV = (300.0, 300.0, 160.0, 120.0)
KJ = jcam.PinholeK(*[jnp.float32(v) for v in KV])
KT = tcam.PinholeK(*[torch.tensor(v) for v in KV])


def to_port(mj):
    return interop.map_from_numpy({f: np.asarray(getattr(mj, f)) for f in jms.MapState._fields})


def sim3_port(Sj):
    return tsim3.Sim3(*(torch.from_numpy(np.array(x)) for x in Sj))


def gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def assert_maps_match(m_t, m_j, atol=1e-5):
    got = interop.map_to_numpy(m_t)
    for f in jms.MapState._fields:
        want = np.asarray(getattr(m_j, f))
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got[f], want, atol=atol, rtol=atol, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want, err_msg=f)


def feats_j(rng, n_feat, uv=None, desc=None, valid=None):
    uv = rng.uniform(0, 300, (n_feat, 2)).astype(np.float32) if uv is None else uv
    desc = rng.randint(0, 2 ** 32, (n_feat, 8), dtype=np.uint64).astype(np.uint32) \
        if desc is None else desc
    valid = np.ones(n_feat, bool) if valid is None else valid
    return FrameFeatures(uv=jnp.asarray(uv), uv_und=jnp.asarray(uv),
                         response=jnp.ones(n_feat), level=jnp.zeros(n_feat, jnp.int32),
                         angle=jnp.zeros(n_feat), desc=jnp.asarray(desc),
                         valid=jnp.asarray(valid))


def build_loop_map(n_kf=12, n_pts=20, seed=0):
    """tests/test_loop.py's map: keyframes along an arc, each with its own
    landmarks in front of it, parents chained."""
    rng = np.random.RandomState(seed)
    n_feat = 32
    m = jms.empty_map(max_kf=16, max_mp=512, n_feat=n_feat)
    Ts = [jse3.exp(jnp.asarray([0.0, 0.25 * i, 0.0, 0.6 * i, 0.0, 0.0])) for i in range(n_kf)]
    for i in range(n_kf):
        f = feats_j(rng, n_feat)
        m, k = jms.add_keyframe(m, f, Ts[i], float(i), jnp.full((n_feat,), jms.NO_MP, jnp.int32),
                                i - 1)
        pts = jnp.asarray(rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)) + \
            jnp.asarray([0.0, 0.0, 4.0])
        idx = jnp.arange(n_pts, dtype=jnp.int32)
        m, _ = jms.add_mappoints(m, jse3.apply(jse3.inverse(Ts[i])[None], pts),
                                 jnp.ones(n_pts, bool), f.desc[:n_pts], k, k, idx, k, idx)
    return m, Ts


def drifted_loop_map():
    """Keyframes 6-11 and their landmarks carry a Sim3 drift S_d."""
    m, Ts = build_loop_map()
    S_d = jsim3.exp(jnp.asarray([0.0, 0.05, 0.0, 0.3, 0.0, 0.1, 0.08]))
    kf_pose = np.array(m.kf_pose)
    for k in range(6, 12):
        S_new = jsim3.compose(jsim3.from_se3(jnp.asarray(kf_pose[k])), jsim3.inverse(S_d))
        kf_pose[k] = np.asarray(jsim3.to_se3_scaled(S_new))
    mp_pos = np.array(m.mp_pos)
    late = np.isin(np.asarray(m.mp_ref_kf), np.arange(6, 12))
    mp_pos[late] = np.asarray(jsim3.apply(S_d, jnp.asarray(mp_pos[late])))
    return m._replace(kf_pose=jnp.asarray(kf_pose), mp_pos=jnp.asarray(mp_pos)), Ts, S_d


@pytest.fixture(scope="module")
def loop_map():
    mj, Ts, S_d = drifted_loop_map()
    return mj, to_port(mj), Ts, S_d


def projected_kf(m, T_cw, pts, desc, ts, parent=-1, n_feat=64):
    """A keyframe whose features are the true projections of pts, with its
    own landmark entries (tests/test_loop.py's duplicate-entry setup)."""
    uv = np.asarray(jcam.project(KJ, jse3.apply(jnp.asarray(T_cw)[None], jnp.asarray(pts))))
    P = pts.shape[0]
    uv_pad = np.zeros((n_feat, 2), np.float32)
    uv_pad[:P] = uv
    desc_pad = np.zeros((n_feat, 8), np.uint32)
    desc_pad[:P] = desc
    valid = np.zeros(n_feat, bool)
    valid[:P] = True
    f = feats_j(None, n_feat, uv_pad, desc_pad, valid)
    m, k = jms.add_keyframe(m, f, jnp.asarray(T_cw), ts,
                            jnp.full((n_feat,), jms.NO_MP, jnp.int32), parent)
    idx = jnp.arange(P, dtype=jnp.int32)
    m, _ = jms.add_mappoints(m, jnp.asarray(pts), jnp.ones(P, bool),
                             jnp.asarray(desc_pad[:P]), k, k, idx, k, idx)
    return m, int(k)


def cascade_map(adversarial):
    """Place A and its revisit B: a genuine loop, or repeated texture (the
    same descriptors, only 20 of 64 points following a similarity)."""
    rng = np.random.RandomState(3)
    P = 64
    p_A = np.stack([rng.uniform(-1.5, 1.5, P), rng.uniform(-1, 1, P),
                    rng.uniform(3, 6, P)], 1).astype(np.float32)
    desc = rng.randint(0, 2 ** 32, (P, 8), dtype=np.uint32)
    m = jms.empty_map(max_kf=16, max_mp=512, n_feat=64)
    m, kA = projected_kf(m, np.eye(4, dtype=np.float32), p_A, desc, 0.0)
    p_B = p_A.copy()
    if adversarial:
        S_d = jsim3.exp(jnp.asarray([0.0, 0.1, 0.0, 0.4, 0.0, 0.2, 0.05]))
        p_B = np.array(jsim3.apply(S_d, jnp.asarray(p_A)))
        p_B[20:] = np.stack([rng.uniform(-1.5, 1.5, P - 20), rng.uniform(-1, 1, P - 20),
                             rng.uniform(3, 6, P - 20)], 1) + np.asarray([0.0, 0.0, 0.5])
    T_b = np.asarray(jse3.exp(jnp.asarray([0.0, 0.03, 0.0, 0.15, 0.05, 0.0])), np.float32)
    m, kB = projected_kf(m, T_b, p_B.astype(np.float32), desc, 9.0, parent=kA)
    return m, kA, kB


# ----------------------------------------------------------------------
# map-level functions
# ----------------------------------------------------------------------

def test_covisibility_matrix_exact_above_256():
    """Two keyframes sharing 300 landmarks (a bf16 product would round the
    count): kf_mp_mask and covisibility_matrix equal JAX's as integers."""
    rng = np.random.RandomState(1)
    n_feat, P = 512, 1024
    mj = jms.empty_map(4, P, n_feat)
    for i in range(3):
        mj, _ = jms.add_keyframe(mj, feats_j(rng, n_feat), jnp.eye(4), float(i),
                                 jnp.full((n_feat,), -1, jnp.int32), i - 1)
    feat = jnp.arange(300, dtype=jnp.int32)
    mj, _ = jms.add_mappoints(mj, jnp.ones((300, 3)), jnp.ones(300, bool),
                              jnp.zeros((300, 8), jnp.uint32), 0, 0, feat, 1, feat + 100)
    mj, _ = jms.add_mappoints(mj, jnp.ones((40, 3)), jnp.ones(40, bool),
                              jnp.zeros((40, 8), jnp.uint32), 1, 1, feat[:40] + 450, 2,
                              feat[:40])
    mt = to_port(mj)
    np.testing.assert_array_equal(tms.kf_mp_mask(mt).numpy(), np.asarray(jms.kf_mp_mask(mj)))
    W = tms.covisibility_matrix(mt).numpy()
    np.testing.assert_array_equal(W, np.asarray(jms.covisibility_matrix(mj)))
    assert W.dtype == np.int32 and W[0, 1] == 300 and W[1, 2] == 40 and W[0, 0] == 0


def test_merge_active_into_matches_jax(loop_map):
    """Keyframes 6-11 moved into a second sub-map, then welded back through
    a Sim3: every field within 1e-6 (relative) of JAX's."""
    mj, _, _, S_d = loop_map
    move = np.arange(16) >= 6
    mj2 = jms.switch_map(mj._replace(
        kf_map_id=jnp.where(jnp.asarray(move), 1, mj.kf_map_id),
        mp_map_id=jnp.where(jnp.isin(mj.mp_ref_kf, jnp.arange(6, 12)), 1, mj.mp_map_id)), 1)
    want = jms.merge_active_into(mj2, 0, S_d)
    got = tms.merge_active_into(to_port(mj2), 0, sim3_port(S_d))
    assert_maps_match(got, want, atol=1e-6)
    assert int(got.active_map) == 0 and (got.kf_map_id.numpy() == 0).all()


def test_correct_loop_matches_jax(loop_map):
    """The drifted arc closed by the true drift: keyframe poses and
    landmark positions within 1e-3 of JAX's, and back near the truth
    (tests/test_loop.py's gate, 0.12)."""
    mj, mt, Ts, S_d = loop_map
    want = jlc.correct_loop(mj, jnp.int32(11), jnp.int32(0), S_d, max_covis_edges=32, iters=12)
    got = tlc.correct_loop(mt, 11, 0, sim3_port(S_d), max_covis_edges=32, iters=12)
    np.testing.assert_allclose(got.kf_pose.numpy(), np.asarray(want.kf_pose), atol=1e-3)
    np.testing.assert_allclose(got.mp_pos.numpy(), np.asarray(want.mp_pos), atol=1e-3)
    for k in range(12):
        err = np.linalg.norm(np.asarray(jse3.log(jse3.compose(
            jnp.asarray(got.kf_pose[k].numpy()), jse3.inverse(Ts[k])))))
        assert err < 0.12, (k, err)
    assert_maps_match(got._replace(kf_pose=mt.kf_pose, mp_pos=mt.mp_pos), mj)


# ----------------------------------------------------------------------
# verification cascade
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cascades():
    out = {}
    for adversarial in (False, True):
        mj, kA, kB = cascade_map(adversarial)
        out[adversarial] = (mj, to_port(mj), kA, kB)
    return out


def test_match_loop_landmarks_and_pair_observations_exact(cascades):
    mj, mt, kA, kB = cascades[False]
    lj = jlc.match_loop_landmarks(mj, jnp.int32(kB), jnp.int32(kA))
    lt = tlc.match_loop_landmarks(mt, kB, kA)
    for f in jlc.LoopMatch._fields:
        np.testing.assert_array_equal(getattr(lt, f).numpy(), np.asarray(getattr(lj, f)), f)
    assert int(lt.valid.sum()) == 64
    idx = np.array(lj.cand_mp)
    for a, b in zip(tlc._pair_observations(mt, kA, torch.from_numpy(idx)),
                    jlc._pair_observations(mj, jnp.int32(kA), jnp.asarray(idx))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_guided_projection_count_exact(cascades):
    """Counted at the same Sim3s (identity, and a wrong one) as JAX."""
    mj, mt, kA, kB = cascades[False]
    lj = jlc.match_loop_landmarks(mj, jnp.int32(kB), jnp.int32(kA))
    for z in (np.zeros(7), np.array([0.0, 0.2, 0.0, 0.5, 0.0, 0.0, 0.1])):
        Sj = jsim3.exp(jnp.asarray(z, jnp.float32))
        want = int(jlc.guided_projection_count(mj, jnp.int32(kB), Sj, lj.cand_region, KJ,
                                               width=320, height=240))
        got = int(tlc.guided_projection_count(mt, kB, sim3_port(Sj),
                                              torch.from_numpy(np.array(lj.cand_region)),
                                              KT, width=320, height=240))
        assert got == want


@pytest.mark.parametrize("adversarial", [False, True])
def test_cascade_reaches_jax_decision(cascades, adversarial):
    """A true loop is accepted and repeated texture rejected by both; on
    repeated texture, Sim3 RANSAC alone accepts in both (the cascade's
    guided projection count is what rejects)."""
    mj, mt, kA, kB = cascades[adversarial]
    cj = jlc.verify_candidate_cascade(mj, kB, kA, jax.random.PRNGKey(0), KJ,
                                      width=320, height=240, min_proj_matches=25)
    ct = tlc.verify_candidate_cascade(mt, kB, kA, gen(0), KT, width=320, height=240,
                                      min_proj_matches=25)
    assert ct.ok == cj.ok == (not adversarial), (ct.n_proj, cj.n_proj)
    if adversarial:
        lt = tlc.match_loop_landmarks(mt, kB, kA)
        assert bool(tlc.verify_loop(mt, lt, gen(1)).ok)
    else:
        assert abs(ct.n_proj - cj.n_proj) <= 2
        for a, b in zip(ct.S, cj.S):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)


def test_nbest_candidates_same_list(loop_map):
    mj, mt, _, _ = loop_map
    scores = np.random.RandomState(7).uniform(0, 0.1, 16).astype(np.float32)
    scores[[3, 4]] = 0.09
    want = jlc.nbest_candidates(mj, scores.copy(), n_best=3, min_score=0.03)
    got = tlc.nbest_candidates(mt, scores.copy(), n_best=3, min_score=0.03)
    assert [(r, round(a, 6)) for r, a, _ in got] == [(r, round(a, 6)) for r, a, _ in want]
    for (_, _, g1), (_, _, g2) in zip(got, want):
        np.testing.assert_array_equal(g1, g2)


def test_pr_step_matches_jax(loop_map):
    """Place recognition on keyframe 11 after 0-10 are in the database:
    scores within 1e-5, the same database rows."""
    mj, mt, _, _ = loop_map
    jv, tv = jvoc.default_vocabulary(6, 3), tvoc.default_vocabulary(6, 3, device="cpu")
    from multi_orbslam3_tpu.bow import database as jdb
    from multi_orbslam3_tpu_torch.bow import database as tdb
    dj, dt = jdb.KeyframeDatabase.empty(16), tdb.KeyframeDatabase.empty(16, device="cpu")
    for k in range(12):
        sj, dj = jlc._pr_step(dj, jv, mj, jnp.int32(k))
        st, dt = tlc._pr_step(dt, tv, mt, k)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5, rtol=0)
    for f in jdb.KeyframeDatabase._fields:
        np.testing.assert_allclose(interop.database_to_numpy(dt)[f], np.asarray(getattr(dj, f)),
                                   atol=1e-5, rtol=0, err_msg=f)
    assert dt.active.numpy()[:12].all()


# ----------------------------------------------------------------------
# essential-graph audit
# ----------------------------------------------------------------------

def corrupt(m, how):
    """A healthy map with one seeded corruption (numpy fields)."""
    d = {f: np.array(getattr(m, f)) for f in jms.MapState._fields}
    if how == "cycle":
        d["kf_parent"][1], d["kf_parent"][2] = 2, 1
    elif how == "erased_parent":
        d["kf_valid"][1] = False
    elif how == "bad_ref":
        d["mp_ref_kf"][np.nonzero(d["mp_valid"])[0][0]] = 10 ** 6
    elif how == "submap_parent":
        d["kf_map_id"][5:] = 1
    return d


@pytest.mark.parametrize("how", [None, "cycle", "erased_parent", "bad_ref", "submap_parent"])
def test_check_essential_graph_matches_jax(loop_map, how):
    """The same summary dict on a healthy map; the same error message on
    each seeded corruption (with the per-sub-map check for the last)."""
    mj, _, _, _ = loop_map
    d = corrupt(mj, how) if how else {f: np.asarray(getattr(mj, f)) for f in jms.MapState._fields}
    kf_map = d["kf_map_id"] if how == "submap_parent" else None
    mj2 = jms.MapState(**{f: jnp.asarray(v) for f, v in d.items()})
    mt2 = to_port(mj2)
    if how is None:
        assert taudit.check_essential_graph(mt2) == jaudit.check_essential_graph(mj2)
        assert taudit.check_essential_graph(mt2)["n_kf"] == 12
        return
    with pytest.raises(jaudit.EssentialGraphError) as ej:
        jaudit.check_essential_graph(mj2, kf_map=kf_map)
    with pytest.raises(taudit.EssentialGraphError) as et:
        taudit.check_essential_graph(mt2, kf_map=None if kf_map is None
                                     else torch.from_numpy(kf_map))
    assert str(et.value) == str(ej.value)
