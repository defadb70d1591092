"""The monocular slice of the PyTorch port against the JAX package, on the
CPU at the small synthetic configuration (320x240, 256 features, 4
levels, 64 keyframes / 2048 landmarks, a k=6 L=3 vocabulary):

(a) the fused extract+track step on a map built by the JAX package from
    ground truth and carried across with interop;
(b) the per-keyframe mapping chain on a carried map;
(c) relocalization against a keyframe of a carried map;
(d) the port's MonoSlam end to end, loop closing off and on, with the JAX
    E2E gates, and a localization-only replay;
(e) one test for each repair of MonoSlam against the JAX system (loop
    closing on by default, bootstrap keyframes, adoption, defer_mapping,
    localization mode, the relocalization random stream);
(f) JAX against the port end to end, and the Atlas drill (slow).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orbslam3_tpu import config as cfg
from multi_orbslam3_tpu.dataio import synthetic
from multi_orbslam3_tpu.eval import ate
from multi_orbslam3_tpu.frontend import extractor as jex
from multi_orbslam3_tpu.geometry import camera as jcam
from multi_orbslam3_tpu.map import mapstate as jms
from multi_orbslam3_tpu.pipeline import local_mapping as jlm
from multi_orbslam3_tpu.pipeline import system as jsys
from multi_orbslam3_tpu.pipeline import tracking as jtr
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch import interop
from multi_orbslam3_tpu_torch.bow import vocabulary as tvoc
from multi_orbslam3_tpu_torch.dataio import synthetic as tsynthetic
from multi_orbslam3_tpu_torch.geometry import camera as tcam
from multi_orbslam3_tpu_torch.map import audit as taudit
from multi_orbslam3_tpu_torch.pipeline import local_mapping as tlm
from multi_orbslam3_tpu_torch.pipeline import system as tsys
from multi_orbslam3_tpu_torch.pipeline import tracking as ttr


# each package gets a config object of its own, built from the same values
CT = tcfg.small_synthetic()


def t(a):
    return torch.from_numpy(np.array(a))


def jax_map_np(m):
    return {f: np.asarray(getattr(m, f)) for f in jms.MapState._fields}


@pytest.fixture(scope="module")
def setup():
    """A JAX-built map from ground truth: keyframe 0 at frame 0 with its
    true pose; each of its features within 4 px of a projected world
    point becomes a landmark, back-projected at that point's true depth."""
    c = cfg.small_synthetic()
    seq = synthetic.make_sequence(c, n_frames=12, n_points=500, seed=7,
                                  trajectory="forward")
    imgs = np.clip(np.round(seq.images), 0, 255).astype(np.uint8)
    n = c.orb.n_features
    m = jms.empty_map(c.map.max_keyframes, c.map.max_mappoints, n)
    f0 = jex.extract_features(jnp.asarray(imgs[0], jnp.float32), c)
    T0 = seq.T_cw[0].astype(np.float64)
    m, _ = jms.add_keyframe(m, f0, jnp.asarray(seq.T_cw[0]), 0.0,
                            jnp.full((n,), -1, jnp.int32), -1)
    cam = c.camera
    pc = seq.points @ T0[:3, :3].T + T0[:3, 3]
    front = pc[:, 2] > 0.3
    proj = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                     cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], 1)
    uv = np.asarray(f0.uv_und).astype(np.float64)
    d = np.linalg.norm(uv[:, None] - proj[None], axis=-1)
    d[:, ~front] = np.inf
    near = d.argmin(1)
    ok = (d.min(1) < 4.0) & np.asarray(f0.valid)
    z = pc[near, 2]
    p_cam = np.stack([(uv[:, 0] - cam.cx) / cam.fx * z,
                      (uv[:, 1] - cam.cy) / cam.fy * z, z], 1)
    p_w = ((p_cam - T0[:3, 3]) @ T0[:3, :3]).astype(np.float32)
    idx = jnp.arange(n, dtype=jnp.int32)
    m, _ = jms.add_mappoints(m, jnp.asarray(p_w), jnp.asarray(ok), f0.desc,
                             0, 0, idx, 0, idx)
    m = jms.refresh_point_stats(m, jnp.zeros(1, jnp.int32), jnp.ones(1, bool),
                                scale_factor=c.orb.scale_factor,
                                n_levels=c.orb.n_levels)
    assert int(m.n_mp) > 100
    return c, seq, imgs, m


def test_fused_step_chained_matches_jax(setup):
    """(a) Pose within 1e-3, n_inliers within 3%, feat_mp equal on >= 95%
    of the features, from the same map, frame and pose chain. Measured on
    the CPU: 69 inliers in both, pose within 3e-8, feat_mp 100% equal."""
    c, seq, imgs, mj = setup
    T_cur = seq.T_cw[4].astype(np.float32)
    T_vel = (seq.T_cw[4] @ np.linalg.inv(seq.T_cw[3])).astype(np.float32)
    fj, rj, pose_j, vel_j = jtr._fused_step_chained(c)(
        mj, jnp.asarray(imgs[5]), jnp.asarray(T_cur), jnp.asarray(T_vel))
    mt = interop.map_from_numpy(jax_map_np(mj))
    ft, rt, pose_t, vel_t = ttr.fused_step_chained(CT, mt, t(imgs[5]), t(T_cur), t(T_vel))
    n_j, n_t = int(rj.n_inliers), int(rt.n_inliers)
    assert n_j > 40
    assert abs(n_t - n_j) <= 0.03 * n_j
    np.testing.assert_allclose(pose_t.numpy(), np.asarray(pose_j), atol=1e-3)
    np.testing.assert_allclose(vel_t.numpy(), np.asarray(vel_j), atol=1e-3)
    assert np.mean(rt.feat_mp.numpy() == np.asarray(rj.feat_mp)) >= 0.95
    np.testing.assert_allclose(rt.packed.numpy()[:18], np.asarray(rj.packed)[:18],
                               atol=1e-3 * max(n_j, 1))
    # the pose is also close to the ground truth
    assert np.abs(pose_t.numpy() - seq.T_cw[5]).max() < 0.05


def test_map_keyframe_matches_jax(setup):
    """(b) A new keyframe at frame 6 (ground-truth pose, the JAX tracker's
    associations), then the whole mapping chain on both: n_created and
    n_fused within 10% (+1 for tiny counts), keyframe poses within 1e-3.
    Measured on the CPU: 11 created in both, poses within 2e-6, landmark
    positions within 7e-4."""
    c, seq, imgs, mj = setup
    Kj = jcam.intrinsics_from_config(c.camera)
    fj, rj, _ = jtr.extract_and_track(mj, jnp.asarray(imgs[6]),
                                      jnp.asarray(seq.T_cw[6]), c)
    mj, k = jms.add_keyframe(mj, fj, jnp.asarray(seq.T_cw[6]),
                             float(seq.timestamps[6]), rj.feat_mp, 0)
    kw = tlm.mapping_kwargs(CT)
    mt = interop.map_from_numpy(jax_map_np(mj))
    out_j = jlm.map_keyframe(mj, k, Kj, **kw)
    Kt = tcam.intrinsics_from_config(CT.camera)
    out_t = tlm.map_keyframe(mt, int(k), Kt, **kw)
    for name in ("n_created", "n_fused"):
        a, b = int(getattr(out_t, name)), int(getattr(out_j, name))
        assert abs(a - b) <= 0.1 * b + 1, (name, a, b)
    assert int(out_j.n_created) > 5
    np.testing.assert_allclose(out_t.map.kf_pose[:2].numpy(),
                               np.asarray(out_j.map.kf_pose[:2]), atol=1e-3)
    assert abs(int(out_t.map.n_mp) - int(out_j.map.n_mp)) <= 0.1 * int(out_j.map.n_mp)


def _run(slam_cls, c, seq, pipelined, **kw):
    if slam_cls is tsys.MonoSlam:
        c, kw = CT, dict(kw, device="cpu")
    slam = slam_cls(c, **kw)
    step = slam.process_frame_pipelined if pipelined else slam.process_frame
    for i in range(seq.images.shape[0]):
        step(seq.images[i], float(seq.timestamps[i]))
    slam.finish()
    states = [s.name for _, s in slam.frame_log]
    n0 = states.index("OK")
    est = np.stack([T for _, T in slam.trajectory])
    e = ate.camera_centers(est[n0:])
    g = ate.camera_centers(seq.T_cw[n0:])
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    return slam, states, ate.ate_rmse(e, g), span


@pytest.fixture(scope="module")
def e2e_seq():
    c = cfg.small_synthetic()
    return c, synthetic.make_sequence(c, n_frames=40, n_points=500, seed=7,
                                      trajectory="forward")


@pytest.mark.parametrize("pipelined", [False, True])
def test_port_end_to_end(e2e_seq, pipelined):
    """(d) The gates of tests/test_pipeline.py's JAX E2E: final state OK,
    >= 3 keyframes, > 25 frames tracked, ATE < 0.05 x span."""
    c, seq = e2e_seq
    slam, states, rmse, span = _run(tsys.MonoSlam, c, seq, pipelined,
                                    enable_loop_closing=False)
    assert slam.state == tsys.TrackState.OK, states
    assert len(states) == seq.images.shape[0]
    assert slam.stats["kf_inserted"] >= 3
    assert slam.stats["frames_tracked"] > 25
    assert rmse < 0.05 * span, f"ATE {rmse:.3f} vs span {span:.2f}"


@pytest.fixture(scope="module")
def small_voc():
    """The small config's vocabulary (trained once, shared by the tests)."""
    c = cfg.small_synthetic()
    return tvoc.default_vocabulary(c.bow.branching, c.bow.levels)


@pytest.fixture(scope="module")
def lc_runs(e2e_seq, small_voc):
    """The port's MonoSlam with loop closing on (the default), one run per
    loop kind, made on first use."""
    c, seq = e2e_seq
    runs = {}

    def get(pipelined):
        if pipelined not in runs:
            runs[pipelined] = _run(tsys.MonoSlam, c, seq, pipelined, vocabulary=small_voc)
        return runs[pipelined]
    return get


@pytest.mark.parametrize("pipelined", [False, True])
def test_port_end_to_end_with_loop_closing(lc_runs, e2e_seq, pipelined):
    """(d) Loop closing on: the JAX E2E gates, every adopted keyframe in
    the loop closer's database, and a clean essential graph."""
    c, seq = e2e_seq
    slam, states, rmse, span = lc_runs(pipelined)
    assert slam.loop_closer is not None
    assert slam.state == tsys.TrackState.OK, states
    assert len(states) == seq.images.shape[0]
    assert slam.stats["kf_inserted"] >= 3
    assert slam.stats["frames_tracked"] > 25
    assert rmse < 0.05 * span, f"ATE {rmse:.3f} vs span {span:.2f}"
    n = int(slam.m.n_kf)
    valid = slam.m.kf_valid[:n].numpy()
    assert slam.loop_closer.db.active[:n].numpy()[valid].all()
    taudit.check_essential_graph(slam.m)


def test_relocalize_candidate_matches_jax(setup):
    """(c) Frame 5 relocalized against keyframe 0 of the carried map from
    scratch (no pose seed): the pose within 1e-2 of JAX's and n_inliers
    within 10%."""
    c, seq, imgs, mj = setup
    fj = jex.extract_features(jnp.asarray(imgs[5], jnp.float32), c)
    Kj = jcam.intrinsics_from_config(c.camera)
    rj = jtr.relocalize_candidate(mj, jnp.int32(0), fj, Kj, jax.random.PRNGKey(0),
                                  scale_factor=c.orb.scale_factor)
    mt = interop.map_from_numpy(jax_map_np(mj))
    ft = interop.features_from_numpy({f: np.asarray(getattr(fj, f))
                                      for f in fj._fields})
    g = torch.Generator()
    g.manual_seed(0)
    rt = ttr.relocalize_candidate(mt, 0, ft, tcam.intrinsics_from_config(CT.camera), g,
                                  scale_factor=c.orb.scale_factor)
    n_j, n_t = int(rj.n_inliers), int(rt.n_inliers)
    assert n_j > 30 and abs(n_t - n_j) <= 0.1 * n_j, (n_t, n_j)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-2)
    np.testing.assert_allclose(rt.pose.numpy(), seq.T_cw[5], atol=0.05)
    np.testing.assert_array_equal(rt.visible.numpy(), np.asarray(rj.visible))
    assert int(rt.n_matches) == int(rj.n_matches)


@pytest.fixture(scope="module")
def replay(lc_runs, e2e_seq, small_voc):
    """A fresh MonoSlam takes the final map of the loop-closing run,
    switches to localization-only mode and replays frames 25-39."""
    c, seq = e2e_seq
    mapper = lc_runs(False)[0]
    loc = tsys.MonoSlam(CT, vocabulary=small_voc, device="cpu")
    loc.m = mapper.m
    loc.activate_localization_mode()
    before = interop.map_to_numpy(loc.m)
    gen_state = loc._gen.get_state()
    reloc_state = loc._reloc_gen.get_state()
    states = [loc.process_frame(seq.images[i], float(seq.timestamps[i]))
              for i in range(25, 40)]
    return loc, states, before, gen_state, reloc_state


def test_localization_only_replay(replay, e2e_seq):
    """(d) Relocalizes at least once, keeps > 60% of the frames OK within
    0.1 x max(span, 1) ATE, and never adds a keyframe or landmark
    (tests/test_localization_mode.py's gates)."""
    _, seq = e2e_seq
    loc, states, before, _, _ = replay
    assert loc.stats.get("relocalizations", 0) >= 1, loc.stats
    ok = [j for j, st in enumerate(states) if st == tsys.TrackState.OK]
    assert len(ok) > 0.6 * len(states), [st.name for st in states]
    after = interop.map_to_numpy(loc.m)
    for f in ("n_kf", "n_mp", "kf_pose", "kf_valid", "kf_mp", "mp_pos", "mp_valid"):
        np.testing.assert_array_equal(after[f], before[f], err_msg=f)
    assert loc.stats["kf_inserted"] == 0
    est = np.stack([loc.trajectory[j][1] for j in ok])
    g = ate.camera_centers(seq.T_cw[np.asarray(ok) + 25])
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    assert ate.ate_rmse(ate.camera_centers(est), g) < 0.1 * max(span, 1.0)


def test_repair_a_loop_closing_on_by_default_with_a_vocabulary(small_voc):
    """(a) The default follows the JAX system (loop closing on), and a
    vocabulary= argument is taken as given; with loop closing off the
    system keeps a relocalization database on the same vocabulary."""
    c = cfg.small_synthetic()
    for cls in (jsys.MonoSlam, tsys.MonoSlam):
        params = inspect.signature(cls).parameters
        assert params["enable_loop_closing"].default is True
        assert "vocabulary" in params
    on = tsys.MonoSlam(CT, vocabulary=small_voc, device="cpu")
    assert on.loop_closer is not None and on.loop_closer.voc is small_voc
    assert on.reloc_db is None
    off = tsys.MonoSlam(CT, enable_loop_closing=False, vocabulary=small_voc,
                        device="cpu")
    assert off.loop_closer is None and off.reloc_voc is small_voc
    assert off.reloc_db.word.shape[0] == c.map.max_keyframes


def test_repair_b_bootstrap_keyframes_reach_the_loop_closer(lc_runs):
    """(b) The two bootstrap keyframes are never adopted from the mapping
    chain; they reach the loop closer's database from the initializer."""
    slam = lc_runs(False)[0]
    assert slam.m.kf_parent[:2].tolist() == [-1, 0]
    assert slam.loop_closer.db.active[:2].tolist() == [True, True]


def test_repair_c_adoption_runs_the_closer_and_regauges(lc_runs, small_voc):
    """(c) Adopting a mapping result runs the loop closer on its keyframe;
    when a loop closes, T_cur is re-gauged through the corrected keyframe
    (T_cur' = T_cur T_k^-1 T_k') and the device pose chain is dropped."""
    mapper = lc_runs(False)[0]
    c = cfg.small_synthetic()
    slam = tsys.MonoSlam(CT, vocabulary=small_voc, device="cpu")
    k = 3
    T_k = mapper.m.kf_pose[k].numpy()
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = [0.1, -0.05, 0.2]
    corrected = mapper.m._replace(kf_pose=mapper.m.kf_pose.clone().index_put_(
        (torch.tensor([k]),), torch.from_numpy(shift @ T_k)[None]))
    calls = []

    def fake_on_keyframe(m, kf, **kw):
        calls.append(kf)
        slam.loop_closer.loops_closed += 1
        return corrected

    slam.loop_closer.on_keyframe = fake_on_keyframe
    slam.T_cur = T_k.copy()
    slam.T_cur[:3, 3] += [0.0, 0.0, 0.5]
    T_cur0 = slam.T_cur.copy()
    slam._T_cur_dev = torch.eye(4)
    slam._pending_map = (mapper.m, k, torch.tensor(0), torch.tensor(0), None)
    slam._adopt_pending(force=True)
    assert calls == [k] and slam.m is corrected and slam._T_cur_dev is None
    want = T_cur0 @ np.linalg.inv(T_k) @ (shift @ T_k)
    np.testing.assert_allclose(slam.T_cur, want, atol=1e-5)


def test_repair_d_defer_mapping_false_adopts_synchronously(small_voc):
    """(d) defer_mapping = False dispatches every keyframe's mapping chain
    for synchronous adoption, even on a mature map."""
    c = cfg.small_synthetic()
    rng = np.random.RandomState(0)
    n = c.orb.n_features
    f = {"uv": rng.uniform(0, 300, (n, 2)).astype(np.float32),
         "response": np.ones(n, np.float32), "level": np.zeros(n, np.int32),
         "angle": np.zeros(n, np.float32),
         "desc": rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32),
         "valid": np.ones(n, bool)}
    f["uv_und"] = f["uv"]
    feats = interop.features_from_numpy(f)
    for defer_mapping, want in ((True, True), (False, False)):
        slam = tsys.MonoSlam(CT, vocabulary=small_voc, device="cpu")
        slam.defer_mapping = defer_mapping
        slam._active_map_kfs = 20
        seen = []
        slam._dispatch_mapping = lambda k, defer=True: seen.append(defer)
        slam._insert_keyframe(feats, torch.full((n,), -1, dtype=torch.int32), 1.0)
        assert seen == [want]


def test_repair_e_localization_mode_switches(small_voc):
    """(e) Localization mode: LOST at once with the database rebuilt over
    the map's keyframes, no keyframe decisions, no map reset when lost;
    a checkpoint path is opened (tests/test_torch_io.py loads one), so a
    missing file is an error and leaves the mode off."""
    c = cfg.small_synthetic()
    slam = tsys.MonoSlam(CT, vocabulary=small_voc, device="cpu")
    with pytest.raises(FileNotFoundError):
        slam.activate_localization_mode("no_such_map.npz")
    assert not slam.localization_only
    slam.activate_localization_mode()
    assert slam.localization_only and slam.state == tsys.TrackState.LOST
    assert slam.lost_count >= 10 ** 6 and not slam._need_keyframe(500)
    slam.deactivate_localization_mode()
    assert not slam.localization_only


def test_lost_localization_relocalizes_before_trusting_its_last_pose(lc_runs, e2e_seq,
                                                                    small_voc):
    """A LOST localization-only system relocalizes first: frame 20 is near
    enough to the identity prior for the JAX package's order (track from
    the last pose, then the reference keyframe) to report OK without a
    relocalization; here the frame is recovered by relocalization, with no
    velocity carried over from the stale pose."""
    c, seq = e2e_seq
    loc = tsys.MonoSlam(CT, vocabulary=small_voc, device="cpu")
    loc.m = lc_runs(False)[0].m
    loc.activate_localization_mode()
    st = loc.process_frame(seq.images[20], float(seq.timestamps[20]))
    assert st == tsys.TrackState.OK
    assert loc.stats.get("relocalizations", 0) == 1
    np.testing.assert_array_equal(loc.T_vel, np.eye(4, dtype=np.float32))


def test_repair_f_relocalization_has_its_own_random_stream(replay):
    """(f) Relocalization draws from its own generator: the replay's
    relocalizations advanced it and left the initializer's untouched."""
    loc, _, _, gen_state, reloc_state = replay
    assert loc._reloc_gen is not loc._gen
    assert torch.equal(loc._gen.get_state(), gen_state)
    assert not torch.equal(loc._reloc_gen.get_state(), reloc_state)


@pytest.mark.slow
def test_port_matches_jax_end_to_end(e2e_seq):
    """(f) Same sequence through both packages (loop closing off in both):
    frames OK within 3 and ATE within 2x of the JAX package's."""
    c, seq = e2e_seq
    _, st_j, ate_j, _ = _run(jsys.MonoSlam, c, seq, True, enable_loop_closing=False)
    _, st_t, ate_t, _ = _run(tsys.MonoSlam, c, seq, True, enable_loop_closing=False)
    assert abs(st_t.count("OK") - st_j.count("OK")) <= 3
    assert ate_t <= 2.0 * ate_j + 1e-3


@pytest.mark.slow
def test_port_matches_jax_end_to_end_with_loop_closing(e2e_seq):
    """(f) Loop closing on in both: frames OK within 3 and ATE within 2x
    of the JAX package's."""
    c, seq = e2e_seq
    _, st_j, ate_j, _ = _run(jsys.MonoSlam, c, seq, True)
    _, st_t, ate_t, _ = _run(tsys.MonoSlam, c, seq, True)
    assert abs(st_t.count("OK") - st_j.count("OK")) <= 3
    assert ate_t <= 2.0 * ate_j + 1e-3


@pytest.mark.slow
def test_port_atlas_loop_welds_submaps_on_revisit():
    """(f) tests/test_multiloop.py's drill through the port on the CPU:
    170 frames of a 2.5 pi orbit with a +10 s timestamp jump at frame 80;
    place recognition must weld the two sub-maps back into one, and the
    final keyframe trajectory must hold ATE < 0.12 x max(span, 1)."""
    c = tcfg.synthetic_mono()
    n_frames = 170
    seq = tsynthetic.make_sequence(c, n_frames=n_frames, n_points=1200, seed=21,
                                  trajectory="circle", phase=1.1, arc=2.5 * np.pi)
    slam = tsys.MonoSlam(c, device="cpu")
    slam.defer_mapping = False
    for i in range(n_frames):
        slam.process_frame(seq.images[i], float(seq.timestamps[i]) + (10.0 if i >= 80 else 0.0))
    slam._adopt_pending(force=True)
    assert slam.stats.get("maps_created", 0) >= 1, slam.stats
    assert slam.loop_closer.loops_closed >= 1, slam.stats
    valid = slam.m.kf_valid.numpy()
    assert len(np.unique(slam.m.kf_map_id.numpy()[valid])) == 1
    taudit.check_essential_graph(slam.m)
    frames, poses = [], []
    for ts, T in slam.keyframe_trajectory():
        fr = int(round((ts - 10.0 if ts > 5.0 else ts) * 20.0))
        if 0 <= fr < n_frames:
            frames.append(fr)
            poses.append(T)
    assert len(poses) >= 15
    gt = ate.camera_centers(seq.T_cw[frames])
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    assert ate.ate_rmse(ate.camera_centers(np.stack(poses)), gt) < 0.12 * max(span, 1.0)
