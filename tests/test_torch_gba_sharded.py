"""The port's sharded global BA against the JAX package's, on the CPU.

The JAX entry shards the observation list over virtual CPU devices
(tests/conftest.py gives 8); the port's over a list of devices that here
repeats the CPU. Both bucket the rows by landmark owner, and every
reduction of the JAX code's psum is a sum of per-shard partials in the
port. On the JAX package's synthetic server arena (eval/gba_scaling.py),
carried to the port by a server checkpoint, the sharded solve must agree
with JAX's sharded solve over as many devices and with the port's
unsharded solve to 1e-3 relative on poses and points and 1e-4 relative on
chi2 (tests/test_torch_collab_map.py's tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.opt import global_ba as jgba
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch.collab.server import CollabServer
from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport
from multi_orbslam3_tpu_torch.opt import global_ba as tgba

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def arena(tmp_path_factory):
    """make_server_arena (48 keyframes, 3072 landmarks, 256 features, 2
    agents) of the JAX package, and the port's server loaded from its
    checkpoint."""
    from multi_orbslam3_tpu.eval.gba_scaling import make_server_arena
    js = make_server_arena(n_kf=48, n_mp=3072, n_feat=256, n_agents=2, seed=0)
    path = str(tmp_path_factory.mktemp("arena") / "server.npz")
    js.save_checkpoint(path)
    tc = tcfg.synthetic_mono().replace(
        orb=tcfg.ORBConfig(n_features=256),
        map=tcfg.MapConfig(max_keyframes=48, max_mappoints=3072, max_obs_per_kf=256))
    ts = CollabServer(tc, InProcessTransport(), n_agents=2, arena_kf=48, arena_mp=3072,
                      device="cpu")
    ts.load_checkpoint(path)
    return js, ts


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def check(rt, rj):
    assert rel_err(rt.poses.numpy(), rj.poses) < 1e-3
    assert rel_err(rt.points.numpy(), rj.points) < 1e-3
    assert abs(float(rt.chi2) - float(rj.chi2)) <= 1e-4 * abs(float(rj.chi2))
    assert abs(float(rt.chi2_in) - float(rj.chi2_in)) <= 1e-4 * abs(float(rj.chi2_in))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_gba_matches_jax_sharded_and_the_unsharded_solve(arena, n):
    js, ts = arena
    obs_j, K_j, fixed, _, _ = js._assemble_gba()
    obs_t, K_t, fixed_t, _, _ = ts._assemble_gba()
    obs_t, K_t = ts._valid_rows(obs_t, K_t)
    kw = dict(iters=2, cg_iters=10)
    rj = jgba.global_bundle_adjust_sharded(js.m.kf_pose, jnp.asarray(fixed), js.m.mp_pos,
                                           js.m.mp_valid, obs_j, K_j,
                                           devices=jax.devices()[:n], **kw)
    f = torch.from_numpy(fixed_t)
    rt = tgba.global_bundle_adjust_sharded(ts.m.kf_pose, f, ts.m.mp_pos, ts.m.mp_valid,
                                           obs_t, K_t, devices=["cpu"] * n, **kw)
    ru = tgba.global_bundle_adjust(ts.m.kf_pose, f, ts.m.mp_pos, ts.m.mp_valid, obs_t,
                                   K_t, **kw)
    check(rt, rj)
    check(rt, ru)
    assert float(rt.chi2) < float(rt.chi2_in)       # the solve did work


def test_shard_rows_puts_each_landmark_in_one_shard():
    """The JAX entry's bucketing: owner = pt * n // P, rows stable-sorted."""
    pt = np.random.RandomState(0).randint(0, 1000, 5000)
    rows = tgba.shard_rows(pt, 1000, 8)
    assert sorted(np.concatenate(rows).tolist()) == list(range(5000))
    for d, r in enumerate(rows):
        assert np.all(np.diff(r) > 0)
        assert np.all(pt[r] * 8 // 1000 == d)


def test_force_shard_on_one_device_matches_the_unsharded_solve(arena):
    js, ts = arena
    obs, K, fixed, _, _ = ts._assemble_gba()
    f = torch.from_numpy(fixed)
    r1 = tgba.global_bundle_adjust_sharded(ts.m.kf_pose, f, ts.m.mp_pos, ts.m.mp_valid,
                                           obs, K, iters=2, cg_iters=10, devices=["cpu"],
                                           force_shard=True)
    ru = tgba.global_bundle_adjust(ts.m.kf_pose, f, ts.m.mp_pos, ts.m.mp_valid, obs, K,
                                   iters=2, cg_iters=10)
    check(r1, ru)


def test_sharded_gba_with_point_fixed(arena):
    js, ts = arena
    pf = np.random.RandomState(9).rand(js.m.max_mp) < 0.3
    obs_j, K_j, fixed, _, _ = js._assemble_gba()
    obs_t, K_t, _, _, _ = ts._assemble_gba()
    rj = jgba.global_bundle_adjust_sharded(js.m.kf_pose, jnp.asarray(fixed), js.m.mp_pos,
                                           js.m.mp_valid, obs_j, K_j, iters=2, cg_iters=10,
                                           devices=jax.devices()[:4],
                                           point_fixed=jnp.asarray(pf))
    rt = tgba.global_bundle_adjust_sharded(ts.m.kf_pose, torch.from_numpy(fixed), ts.m.mp_pos,
                                           ts.m.mp_valid, obs_t, K_t, iters=2, cg_iters=10,
                                           devices=["cpu"] * 4,
                                           point_fixed=torch.from_numpy(pf))
    check(rt, rj)
    moved = np.abs(rt.points.numpy() - ts.m.mp_pos.numpy()).max(1) > 0
    assert not moved[pf].any()


def test_the_shard_reduction_sums_partials_on_one_device():
    parts = [torch.full((3, 6), float(i)) for i in range(4)]
    out = tgba._reduce(parts, torch.device("cpu"))
    assert torch.equal(out, torch.full((3, 6), 6.0))


def test_the_ports_arena_equals_the_jax_packages():
    """eval/gba_scaling.make_server_arena draws the same arena."""
    from multi_orbslam3_tpu.eval.gba_scaling import make_server_arena as jmake
    from multi_orbslam3_tpu_torch import interop
    from multi_orbslam3_tpu_torch.eval.gba_scaling import make_server_arena as tmake
    js = jmake(n_kf=24, n_mp=1024, n_feat=64, n_agents=3, seed=2)
    ts = tmake(n_kf=24, n_mp=1024, n_feat=64, n_agents=3, seed=2, device="cpu")
    got = interop.map_to_numpy(ts.m)
    for f in ("kf_pose", "kf_uv", "mp_pos"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(js.m, f)), rtol=1e-5, atol=2e-5,
                                   err_msg=f)
    for f in ("kf_mp", "kf_feat_valid", "kf_agent", "kf_valid", "mp_valid", "n_kf", "n_mp"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(js.m, f)), err_msg=f)
    np.testing.assert_array_equal(ts.kf_map, js.kf_map)
    np.testing.assert_array_equal(ts.kf_local, js.kf_local)


def test_measure_gba_reports_a_rate():
    from multi_orbslam3_tpu_torch.eval.gba_scaling import make_server_arena, measure_gba
    out = measure_gba(make_server_arena(n_kf=16, n_mp=512, n_feat=64, device="cpu"),
                      iters=1, cg_iters=5, reps=1, devices=["cpu"] * 2)
    assert out["device"] == "cpu" and out["shards"] == 2 and out["gba_iters_per_s"] > 0


def test_dryrun_multichip_over_four_cpu_shards():
    from multi_orbslam3_tpu_torch.dryrun import dryrun_multichip
    out = dryrun_multichip(["cpu"] * 4)
    assert out["shards"] == 4 and out["gba_runs"] == 1
    assert out["chi2_after"] <= 1.01 * out["chi2_before"]


def test_the_cross_card_reduction_is_bound_after_importing_the_module():
    """`import torch` alone does not load torch.cuda.comm; the sharded
    solve's reduction across distinct cards calls its reduce_add, so the
    module must load it (a fresh interpreter, as a server process is)."""
    import subprocess
    import sys
    code = ("import torch\n"
            "from multi_orbslam3_tpu_torch.opt import global_ba\n"
            "assert callable(torch.cuda.comm.reduce_add)\n")
    subprocess.run([sys.executable, "-c", code], check=True)
