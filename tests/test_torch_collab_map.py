"""The map functions the collaborative server needs, against the JAX
package, on the CPU: the batched keyframe insert, the raw landmark insert,
keyframe and landmark erasure and the three culling functions must agree
exactly (integers and masks) or to 1e-6 (floats); the global BA runs on
the JAX package's synthetic server arena (eval/gba_scaling.py), carried to
the port by a server checkpoint, and must agree to 1e-3 relative on poses
and points and 1e-4 relative on the chi2 it reports."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.map import mapstate as jms
from multi_orbslam3_tpu.opt import global_ba as jgba
from multi_orbslam3_tpu.pipeline import culling as jcull
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.collab.server import CollabServer
from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport
from multi_orbslam3_tpu_torch.map import mapstate as tms
from multi_orbslam3_tpu_torch.opt import global_ba as tgba
from multi_orbslam3_tpu_torch.pipeline import culling as tcull

torch.set_num_threads(2)
K_KF, P, N = 12, 160, 24


def jax_np(m):
    return {f: np.asarray(getattr(m, f)) for f in jms.MapState._fields}


def assert_maps_match(m_t, m_j, atol=1e-6):
    got, want = interop.map_to_numpy(m_t), jax_np(m_j)
    for f in want:
        if want[f].dtype.kind == "f":
            np.testing.assert_allclose(got[f], want[f], atol=atol, rtol=atol, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def random_map(seed, n_kf=8, n_mp=120):
    """A populated map: n_kf keyframes with random poses, features and
    associations (a third unbound), n_mp landmarks with random statistics;
    the same numpy arrays go into both packages."""
    rng = np.random.RandomState(seed)
    d = {f: np.array(v) for f, v in jax_np(jms.empty_map(K_KF, P, N)).items()}
    for k in range(n_kf):
        R, _ = np.linalg.qr(rng.randn(3, 3))
        d["kf_pose"][k, :3, :3] = R * np.sign(np.linalg.det(R))
        d["kf_pose"][k, :3, 3] = rng.randn(3)
    d["kf_valid"][:n_kf] = rng.rand(n_kf) < 0.9
    d["kf_valid"][0] = True
    d["kf_parent"][1:n_kf] = np.arange(n_kf - 1)
    d["kf_agent"][:n_kf] = rng.randint(0, 2, n_kf)
    d["kf_timestamp"][:n_kf] = np.arange(n_kf) * 0.5
    d["kf_uv"][:n_kf] = rng.uniform(0, 300, (n_kf, N, 2))
    d["kf_desc"][:n_kf] = rng.randint(0, 2 ** 32, (n_kf, N, 8), dtype=np.uint64)
    d["kf_level"][:n_kf] = rng.randint(0, 4, (n_kf, N))
    d["kf_feat_valid"][:n_kf] = rng.rand(n_kf, N) < 0.9
    mp = rng.randint(0, n_mp, (n_kf, N)).astype(np.int32)
    d["kf_mp"][:n_kf] = np.where(rng.rand(n_kf, N) < 0.66, mp, -1)
    d["mp_pos"][:n_mp] = rng.randn(n_mp, 3) + [0, 0, 5]
    d["mp_valid"][:n_mp] = rng.rand(n_mp) < 0.95
    d["mp_desc"][:n_mp] = rng.randint(0, 2 ** 32, (n_mp, 8), dtype=np.uint64)
    d["mp_ref_kf"][:n_mp] = rng.randint(0, n_kf, n_mp)
    d["mp_found"][:n_mp] = rng.randint(0, 12, n_mp)
    d["mp_visible"][:n_mp] = d["mp_found"][:n_mp] + rng.randint(0, 30, n_mp)
    # landmark 0 is young and never looked for, so culling never picks it:
    # the JAX erase parks its skipped writes at slot 0, where an erasure
    # of slot 0 itself can be undone (the port writes them to a spare row)
    d["mp_ref_kf"][0], d["mp_found"][0], d["mp_visible"][0] = n_kf - 1, 0, 0
    d["n_kf"] = np.int32(n_kf)
    d["n_mp"] = np.int32(n_mp)
    mj = jms.MapState(**{f: jnp.asarray(v) for f, v in d.items()})
    return mj, interop.map_from_numpy(d)


def kf_batch(seed, B):
    rng = np.random.RandomState(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    poses[:, :3, 3] = rng.randn(B, 3)
    return dict(
        poses=poses, timestamps=rng.rand(B).astype(np.float32),
        agents=rng.randint(0, 3, B).astype(np.int32),
        parents=rng.randint(-1, 5, B).astype(np.int32),
        assocs=rng.randint(-1, 100, (B, N)).astype(np.int32),
        uv=rng.uniform(0, 300, (B, N, 2)).astype(np.float32),
        desc=rng.randint(0, 2 ** 32, (B, N, 8), dtype=np.uint64).astype(np.uint32),
        level=rng.randint(0, 4, (B, N)).astype(np.int32),
        angle=rng.randn(B, N).astype(np.float32),
        feat_valid=rng.rand(B, N) < 0.8,
        cams=np.tile(np.asarray([300.0, 310.0, 160.0, 120.0], np.float32), (B, 1)))


def torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items() if k != "desc"}
    out["desc"] = torch.from_numpy(b["desc"].view(np.int32))
    return out


@pytest.mark.parametrize("n_kf,B,count", [(8, 4, 3), (10, 4, 4), (12, 3, 2)])
def test_add_keyframes_batch_matches_jax(n_kf, B, count):
    """Padding rows past `count` and rows past capacity write nothing."""
    mj, mt = random_map(1, n_kf=n_kf)
    b = kf_batch(2, B)
    mj2, sj = jms.add_keyframes_batch(mj, *(jnp.asarray(b[k]) for k in (
        "poses", "timestamps", "agents", "parents", "assocs", "uv", "desc", "level",
        "angle", "feat_valid")), jnp.int32(count), cams=jnp.asarray(b["cams"]))
    tb = torch_batch(b)
    mt2, st = tms.add_keyframes_batch(mt, *(tb[k] for k in (
        "poses", "timestamps", "agents", "parents", "assocs", "uv", "desc", "level",
        "angle", "feat_valid")), count, cams=tb["cams"])
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert_maps_match(mt2, mj2)


@pytest.mark.parametrize("n_mp,full", [(120, False), (P, True)])
def test_add_mappoints_raw_matches_jax(n_mp, full):
    """Rows with ok False and every row of a full arena create nothing."""
    mj, mt = random_map(3, n_mp=n_mp)
    rng = np.random.RandomState(4)
    B = 10
    pos = rng.randn(B, 3).astype(np.float32) + [0, 0, 4]
    ok = rng.rand(B) < 0.7
    desc = rng.randint(0, 2 ** 32, (B, 8), dtype=np.uint64).astype(np.uint32)
    ref = rng.randint(-1, 9, B).astype(np.int32)
    for fn_j, fn_t in ((jms.add_mappoints_raw, tms.add_mappoints_raw),
                       (jms.add_mappoints_raw_padded, tms.add_mappoints_raw_padded)):
        mj2, sj = fn_j(mj, jnp.asarray(pos), jnp.asarray(ok), jnp.asarray(desc),
                       jnp.asarray(ref), 1)
        mt2, st = fn_t(mt, torch.from_numpy(pos), torch.from_numpy(ok),
                       torch.from_numpy(desc.view(np.int32)), torch.from_numpy(ref), 1)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        assert (st.numpy() < 0).all() == full
        assert_maps_match(mt2, mj2)


@pytest.mark.parametrize("kf", [0, 3, 7])
def test_erase_keyframe_matches_jax(kf):
    """Children of the erased keyframe re-parent to its parent."""
    mj, mt = random_map(5)
    assert_maps_match(tms.erase_keyframe(mt, kf), jms.erase_keyframe(mj, jnp.int32(kf)))
    assert_maps_match(tms.erase_keyframe(mt, torch.tensor(kf)),
                      jms.erase_keyframe(mj, jnp.int32(kf)))


def test_erase_mappoints_matches_jax():
    """-1 entries are skipped. (The JAX function parks them at slot 0, the
    port in a sacrificial row; the list leaves slot 0 out, where the two
    would differ only if slot 0 were also erased.)"""
    mj, mt = random_map(6)
    slots = np.asarray([5, -1, 17, 17, 99, -1, 1], np.int32)
    assert_maps_match(tms.erase_mappoints(mt, torch.from_numpy(slots)),
                      jms.erase_mappoints(mj, jnp.asarray(slots)))


def test_erase_mappoints_with_slot_0_and_skipped_rows():
    """The port erases slot 0 even beside -1 entries (no parked write)."""
    _, mt = random_map(6)
    m2 = tms.erase_mappoints(mt, torch.tensor([-1, 0, -1], dtype=torch.int32))
    assert not bool(m2.mp_valid[0]) and not bool((m2.kf_mp == 0).any())
    assert torch.equal(m2.mp_valid[1:], mt.mp_valid[1:])


@pytest.mark.parametrize("seed", [7, 8])
def test_culling_matches_jax(seed):
    mj, mt = random_map(seed, n_kf=10, n_mp=60)
    protect = np.zeros(K_KF, bool)
    protect[[0, 9]] = True
    np.testing.assert_array_equal(
        tcull.redundant_keyframes(mt, torch.from_numpy(protect)).numpy(),
        np.asarray(jcull.redundant_keyframes(mj, jnp.asarray(protect))))
    for age in (3, 6):
        np.testing.assert_array_equal(
            tcull.orphan_mappoints(mt, age_kf=age).numpy(),
            np.asarray(jcull.orphan_mappoints(mj, age_kf=age)))
    mt2, nk_t, nm_t = tcull.cull(mt, torch.from_numpy(protect), age_kf=6)
    mj2, nk_j, nm_j = jcull.cull(mj, jnp.asarray(protect), age_kf=6)
    assert (nk_t, nm_t) == (nk_j, nm_j)
    assert nk_t + nm_t > 0
    assert_maps_match(mt2, mj2)


# ---------------------------------------------------------------------------
# global BA on the synthetic server arena
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def arena(tmp_path_factory):
    """The JAX package's make_server_arena (48 keyframes, 3072 landmarks,
    256 features, 2 agents), carried to the port's server by a checkpoint."""
    from multi_orbslam3_tpu.eval.gba_scaling import make_server_arena
    js = make_server_arena(n_kf=48, n_mp=3072, n_feat=256, n_agents=2, seed=0)
    path = str(tmp_path_factory.mktemp("arena") / "server.npz")
    js.save_checkpoint(path)
    c = js.cfg
    tc = tcfg.synthetic_mono().replace(
        orb=tcfg.ORBConfig(n_features=c.orb.n_features),
        map=tcfg.MapConfig(max_keyframes=48, max_mappoints=3072, max_obs_per_kf=256))
    ts = CollabServer(tc, InProcessTransport(), n_agents=2, arena_kf=48, arena_mp=3072,
                      device="cpu")
    ts.load_checkpoint(path)
    return js, ts


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def run_both(js, ts, point_fixed=None, slices=None, iters=2, cg_iters=10):
    """One solve of `iters` steps, or `slices` one-step solves carrying lam."""
    obs_j, K_j, fixed, _, _ = js._assemble_gba()
    obs_t, K_t, fixed_t, _, _ = ts._assemble_gba()
    np.testing.assert_array_equal(fixed_t, fixed)
    pf_j = None if point_fixed is None else jnp.asarray(point_fixed)
    pf_t = None if point_fixed is None else torch.from_numpy(point_fixed)
    pj, xj, lam_j = js.m.kf_pose, js.m.mp_pos, 1e-3
    pt, xt, lam_t = ts.m.kf_pose, ts.m.mp_pos, 1e-3
    out = []
    for it in ([1] * slices if slices else [iters]):
        rj = jgba.global_bundle_adjust(pj, jnp.asarray(fixed), xj, js.m.mp_valid, obs_j,
                                       K_j, iters=it, cg_iters=cg_iters, lam0=lam_j,
                                       point_fixed=pf_j)
        rt = tgba.global_bundle_adjust(pt, torch.from_numpy(fixed), xt, ts.m.mp_valid,
                                       obs_t, K_t, iters=it, cg_iters=cg_iters, lam0=lam_t,
                                       point_fixed=pf_t)
        pj, xj, lam_j = rj.poses, rj.points, rj.lam
        pt, xt, lam_t = rt.poses, rt.points, rt.lam
        out.append((rj, rt))
    return out


def check(rj, rt, moved_from=None):
    assert rel_err(rt.poses.numpy(), rj.poses) < 1e-3
    assert rel_err(rt.points.numpy(), rj.points) < 1e-3
    assert abs(float(rt.chi2) - float(rj.chi2)) <= 1e-4 * abs(float(rj.chi2))
    assert abs(float(rt.chi2_in) - float(rj.chi2_in)) <= 1e-4 * abs(float(rj.chi2_in))
    assert float(rt.lam) == pytest.approx(float(rj.lam), rel=1e-6)
    if moved_from is not None:
        assert float(rt.chi2) < float(rt.chi2_in)       # the solve did work


def test_the_arena_carries_across_by_checkpoint(arena):
    js, ts = arena
    assert_maps_match(ts.m, js.m, atol=0)
    np.testing.assert_array_equal(ts.kf_map, js.kf_map)
    np.testing.assert_array_equal(ts.kf_local, js.kf_local)


def test_global_bundle_adjust_matches_jax(arena):
    js, ts = arena
    [(rj, rt)] = run_both(js, ts)
    check(rj, rt, moved_from=True)


def test_global_bundle_adjust_with_point_fixed_matches_jax(arena):
    js, ts = arena
    pf = np.random.RandomState(9).rand(js.m.max_mp) < 0.3
    [(rj, rt)] = run_both(js, ts, point_fixed=pf)
    check(rj, rt, moved_from=True)
    held = torch.from_numpy(pf)
    assert torch.equal(rt.points[held], ts.m.mp_pos[held])


def test_global_bundle_adjust_carries_lam_across_one_step_slices(arena):
    js, ts = arena
    for rj, rt in run_both(js, ts, slices=3):
        check(rj, rt)


def test_arena_gauge_and_chi2_match_jax(arena):
    """_assemble_gba's observation list and masks, _arena_robust_chi2 and
    _kf_inlier_counts on the same arena."""
    from multi_orbslam3_tpu.collab import server as jserver
    from multi_orbslam3_tpu_torch.collab import server as tserver
    js, ts = arena
    obs_j, K_j, fixed_j, inert_j, pf_j = js._assemble_gba()
    obs_t, K_t, fixed_t, inert_t, pf_t = ts._assemble_gba()
    for f in ("kf", "pt", "uv", "inv_sigma2", "valid"):
        np.testing.assert_allclose(getattr(obs_t, f).numpy(), np.asarray(getattr(obs_j, f)),
                                   rtol=1e-7, err_msg=f)
    for a, b in zip(K_t, K_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(fixed_t, fixed_j)
    assert inert_t == inert_j == [] and pf_t is None and pf_j is None
    assert ts._arena_robust_chi2() == pytest.approx(js._arena_robust_chi2(), rel=1e-5)
    nj = jserver._kf_inlier_counts(js.m.kf_pose, js.m.mp_pos, obs_j, K_j, js.m.max_kf)
    nt = tserver._kf_inlier_counts(ts.m.kf_pose, ts.m.mp_pos, obs_t, K_t, ts.m.max_kf)
    for a, b in zip(nt, nj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gba_leaves_out_observations_of_invalid_landmarks(arena):
    """A fault of the reference fixed in the port: an arena row that still
    names an invalidated landmark (fusion chains leave a few) is masked
    out of the observation list. The JAX package keeps it, and the point
    then enters the Schur complement with C^-1 = I. The port's solve on
    the arena with such rows still lowers the chi2."""
    js, ts = arena
    m = ts.m
    seen = torch.unique(m.kf_mp[m.kf_mp >= 0])[:40]
    ts.m = m._replace(mp_valid=m.mp_valid.index_put((seen.long(),), torch.tensor(False)))
    try:
        obs, K_obs, fixed, _, _ = ts._assemble_gba()
        stale = obs.valid & ~ts.m.mp_valid[obs.pt.long()]
        assert int(stale.sum()) == 0
        full_rows = int(((m.kf_mp >= 0) & m.kf_feat_valid & m.kf_valid[:, None]).sum())
        assert int(obs.valid.sum()) < full_rows
        obs_c, K_c = ts._valid_rows(obs, K_obs)
        assert obs_c.valid.all() and obs_c.kf.shape[0] == int(obs.valid.sum())
        r = tgba.global_bundle_adjust(ts.m.kf_pose, torch.from_numpy(fixed), ts.m.mp_pos,
                                      ts.m.mp_valid, obs_c, K_c, iters=2, cg_iters=10)
        assert float(r.chi2) < float(r.chi2_in)
        # the compacted list solves like the full one
        r_full = tgba.global_bundle_adjust(ts.m.kf_pose, torch.from_numpy(fixed), ts.m.mp_pos,
                                           ts.m.mp_valid, obs, K_obs, iters=2, cg_iters=10)
        assert rel_err(r.poses.numpy(), r_full.poses.numpy()) < 1e-4
        assert float(r.chi2) == pytest.approx(float(r_full.chi2), rel=1e-5)
    finally:
        ts.m = m
