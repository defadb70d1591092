"""Full-system accuracy + throughput benchmarks (counterpart of
multi_orbslam3_tpu/eval/benchmarks.py).

The reference validates end-to-end: run sequences, save keyframe
trajectories, compare ATE against ground truth
(src/ServerSystem.cc:134-185, ros/launch/Server_euroc.launch:12). This
module does the same in-process, on the port, for every BASELINE.json
configuration:

- mono           : full MonoSlam w/ loop closing on a synthetic sequence
- stereo         : StereoSlam (metric scale, no-scale Umeyama alignment)
- mono_inertial  : MonoInertialSlam with the EuRoC camera-IMU extrinsics
- collab_2agent  : two CollabClients + CollabServer over a shared world
- gba            : global-BA iterations/s on the final arena

The configurations, sequences, protocols and report keys are the JAX
package's. mono runs two passes (the first warms the kernel build, the
allocator and the first use of every path; the second is timed on a fresh
system); stereo and mono_inertial keep the JAX package's two passes too.
fps covers the whole pipeline (keyframe insertion, triangulation, fusion,
local BA, loop closing), not the tracking kernel alone.

Every function takes ``device=None``, the CUDA device, and raises where
there is none (``devices.resolve``); the CPU tests pass ``device="cpu"``.
A time taken on the CPU is a time of PyTorch's CPU kernels, not of the
card. An EuRoC runner activates when a dataset directory exists
(dataio/euroc.py ASL layout).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from multi_orbslam3_tpu_torch import config as cfg
from multi_orbslam3_tpu_torch import devices
from multi_orbslam3_tpu_torch.eval import ate

# EuRoC cam0 body-from-camera extrinsics (the dataset's T_BS; the
# reference loads it as Tbc from ros/conf EuRoC yaml — far from identity)
EUROC_T_BC = (
    0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
    0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
    -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
    0.0, 0.0, 0.0, 1.0)


def _euroc_scale_config(**kw) -> cfg.SystemConfig:
    cam = cfg.CameraConfig(width=752, height=480, fx=458.654, fy=457.296,
                           cx=376.0, cy=240.0, **kw)
    return cfg.SystemConfig(camera=cam)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _ate_over_ok(trajectory, states, gt_T_cw, with_scale=True,
                 skip_head: int = 0) -> Optional[Dict]:
    from multi_orbslam3_tpu_torch.pipeline.system import TrackState
    ok_idx = [i for i, s in enumerate(states)
              if s == TrackState.OK and i >= skip_head]
    if len(ok_idx) < 10:
        return None
    est = np.stack([trajectory[i][1] for i in ok_idx])
    gt = gt_T_cw[ok_idx]
    e = ate.camera_centers(est)
    g = ate.camera_centers(gt)
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    return {"ate_rmse": round(ate.ate_rmse(e, g, with_scale), 4),
            "span": round(span, 3), "frames_ok": len(ok_idx)}


def _drive_mono(slam_factory, seq) -> Dict:
    """Two passes: warm-up + timed run on a fresh system. Frames are
    double-buffered: the next frame's uint8 host->device transfer is
    issued while the current frame computes (a real camera pipeline DMAs
    the same way)."""
    F = seq.images.shape[0]
    frame_ms: List[float] = []
    for timed in (False, True):
        slam = slam_factory()
        frame_ms = []
        nxt = slam.to_device(seq.images[0])
        t0 = time.perf_counter()
        for i in range(F):
            tf = time.perf_counter()
            cur = nxt
            if i + 1 < F:
                nxt = slam.to_device(seq.images[i + 1])
            slam.process_frame_pipelined(cur, float(seq.timestamps[i]))
            frame_ms.append((time.perf_counter() - tf) * 1e3)
        slam.finish()
        _sync(slam.device)
        wall = time.perf_counter() - t0
    fm = np.asarray(frame_ms)
    states = [s for _, s in slam.frame_log]
    out = {"fps": round(F / wall, 2), "frames": F, "wall_s": round(wall, 2),
           "frame_ms_p50": round(float(np.percentile(fm, 50)), 1),
           "frame_ms_p99": round(float(np.percentile(fm, 99)), 1),
           "stats": dict(slam.stats)}
    acc = _ate_over_ok(slam.trajectory, states, seq.T_cw)
    if acc:
        out.update(acc)
    return out


def bench_mono(n_frames: int = 120, seed: int = 5, device=None) -> Dict:
    device = devices.resolve(device, "bench_mono")
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam
    c = _euroc_scale_config()
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=1500,
                                  seed=seed, trajectory="forward")
    return _drive_mono(lambda: MonoSlam(c, enable_loop_closing=True, device=device), seq)


def bench_stereo(n_frames: int = 80, seed: int = 9, device=None) -> Dict:
    device = devices.resolve(device, "bench_stereo")
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.pipeline.stereo_system import StereoSlam
    c = _euroc_scale_config(baseline=0.11)   # EuRoC stereo baseline ~11 cm
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=1200,
                                  seed=seed, trajectory="forward")
    F = seq.images.shape[0]
    for timed in (False, True):
        slam = StereoSlam(c, enable_loop_closing=True, device=device)
        t0 = time.perf_counter()
        for i in range(F):
            slam.process_frame_stereo_pipelined(
                seq.images[i], seq.images_right[i],
                float(seq.timestamps[i]))
        slam.finish()
        _sync(slam.device)
        wall = time.perf_counter() - t0
    states = [s for _, s in slam.frame_log]
    out = {"fps": round(F / wall, 2), "frames": F, "wall_s": round(wall, 2),
           "stats": dict(slam.stats)}
    acc = _ate_over_ok(slam.trajectory, states, seq.T_cw, with_scale=False)
    if acc:
        out.update(acc)
    return out


def bench_mono_inertial(n_frames: int = 90, seed: int = 7, device=None) -> Dict:
    device = devices.resolve(device, "bench_mono_inertial")
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.pipeline.inertial_system import MonoInertialSlam
    c = _euroc_scale_config()
    c = c.replace(imu=cfg.IMUConfig(T_bc=EUROC_T_BC))
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=1200,
                                  seed=seed, trajectory="forward", imu=True,
                                  lateral=0.8, sway_freq=0.15)
    F = seq.images.shape[0]
    rate = c.imu.rate_hz
    for timed in (False, True):
        slam = MonoInertialSlam(c, enable_loop_closing=True, device=device)
        states = []
        t0 = time.perf_counter()
        for i in range(F):
            dt = np.diff(seq.imu_t[i], prepend=seq.imu_t[i][0] - 1.0 / rate)
            dt = np.where(seq.imu_t[i] > 0, np.maximum(dt, 0.0), 0.0)
            states.append(slam.process_frame_imu(
                seq.images[i], float(seq.timestamps[i]),
                seq.imu_acc[i], seq.imu_gyro[i], dt))
        _sync(slam.device)
        wall = time.perf_counter() - t0
    out = {"fps": round(F / wall, 2), "frames": F, "wall_s": round(wall, 2),
           "imu_initialized": bool(slam.imu_initialized),
           "stats": dict(slam.stats)}
    # accuracy protocol: the FINAL map's keyframe trajectory (reference
    # SaveKeyFrameTrajectoryEuRoC — evaluated after the run). The
    # per-frame live log spans every mid-run re-gauge (first VI init,
    # the 4 s VIBA2-analog refinement) and cannot be aligned as one
    # rigid/similar set; keyframe poses all live in the final gauge.
    kf_traj = slam.keyframe_trajectory()
    init_ts = None
    init_f = slam.stats.get("imu_init_frame")
    if init_f is not None and init_f < F:
        init_ts = float(seq.timestamps[init_f]) - float(seq.timestamps[0])
    frames, poses = [], []
    ts0 = float(seq.timestamps[0])
    for t, T in kf_traj:
        if init_ts is not None and t < init_ts:
            continue                    # pre-init segment: visual gauge
        fr = int(round((t - ts0) / (1.0 / c.camera.fps)))
        if 0 <= fr < F:
            frames.append(fr)
            poses.append(T)
    if len(frames) >= 8:
        est = ate.camera_centers(np.stack(poses))
        g = ate.camera_centers(seq.T_cw[frames])
        span = float(np.linalg.norm(g.max(0) - g.min(0)))
        out.update({"ate_rmse": round(ate.ate_rmse(est, g), 4),
                    "span": round(span, 3), "kf_evaluated": len(frames)})
    return out


def bench_collab(n_agents: int = 2, n_frames: int = 150,
                 seed: int = 31, warmup: bool = True, device=None):
    """Collaborative benchmark (BASELINE.json configs #4-5): every agent
    orbits the shared world on a circular arc with a phase offset, so the
    run produces BOTH cross-agent merges (overlapping arcs) and loop
    closures (arc self-overlap), with the post-event GBA on by default
    (the reference's LoopClosing.cc:1286-1292 behavior). Returns
    (report, server); the report has each agent's server-arena keyframe
    ATE (the reference's SaveKeyFrameTrajectoryEuRoC on the server)."""
    device = devices.resolve(device, "bench_collab")
    from multi_orbslam3_tpu_torch.collab import CollabClient, CollabServer
    from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.pipeline.system import TrackState
    c = cfg.synthetic_mono()
    # start phases >= 1.1 rad (initialization needs the later arc's
    # landmark visibility) and arc > 2*pi (each agent's final ~15% of
    # frames re-traverse its own start region, so same-map loop closures
    # are possible): the JAX package's reasons, eval/benchmarks.py:200-209
    seqs = [synthetic.make_sequence(c, n_frames=n_frames, n_points=1200,
                                    seed=seed, trajectory="circle",
                                    phase=1.1 + 0.55 * a,
                                    arc=2.3 * np.pi)
            for a in range(n_agents)]
    passes = (False, True) if warmup else (True,)
    for timed in passes:
        tr = InProcessTransport()
        clients = [CollabClient(c, a, tr, device=device) for a in range(n_agents)]
        server = CollabServer(c, tr, n_agents=n_agents, device=device)
        states = [[] for _ in range(n_agents)]
        first_corr = [None] * n_agents
        frame_t = []
        t0 = time.perf_counter()
        for i in range(n_frames):
            ft0 = time.perf_counter()
            for a, cl in enumerate(clients):
                states[a].append(cl.process_frame(
                    seqs[a].images[i], float(seqs[a].timestamps[i])))
                cl.comm_cycle()
                if first_corr[a] is None and \
                        cl.stats["corrections_applied"] > 0:
                    first_corr[a] = i
            server.comm_cycle()
            frame_t.append(time.perf_counter() - ft0)
        server.drain_gba()      # adopt any time-sliced GBA still in flight
        _sync(server.device)
        wall = time.perf_counter() - t0
    # both throughput definitions under distinct keys: frames/wall, and the
    # steady state over the tail two-thirds (the first third pays the
    # first use of every path)
    total_fps_wall = n_agents * n_frames / wall
    tail = frame_t[len(frame_t) // 3:]
    total_fps_tail = n_agents / max(float(np.mean(tail)), 1e-9)
    total_fps = total_fps_wall if warmup else total_fps_tail
    out = {"agents": n_agents, "frames": n_frames,
           "total_fps": round(total_fps, 2),
           "total_fps_wall": round(total_fps_wall, 2),
           "total_fps_tail": round(total_fps_tail, 2),
           "fps_mode": "two_pass_wall" if warmup else "single_pass_tail",
           "wall_s": round(wall, 2),
           "merges": server.stats["merges"], "loops": server.stats["loops"],
           "bytes_up_mb": round(tr.bytes_up / 2 ** 20, 1),
           "bytes_down_mb": round(tr.bytes_down / 2 ** 20, 1),
           "server": dict(server.stats)}
    # accuracy metric: the final corrected keyframe trajectory from the
    # server arena per agent, matched to ground truth by (sequence-
    # relative) timestamp
    ates = []
    ts_all = np.asarray(seqs[0].timestamps)
    ts_all = ts_all - ts_all[0]
    kf_valid = _host(server.m.kf_valid)
    kf_agent = _host(server.m.kf_agent)
    kf_ts = _host(server.m.kf_timestamp)
    kf_pose = _host(server.m.kf_pose)
    for a, cl in enumerate(clients):
        sel = np.nonzero(kf_valid & (kf_agent == a))[0]
        acc = None
        if len(sel) >= 8:
            fr = np.asarray([int(np.argmin(np.abs(ts_all - t)))
                             for t in kf_ts[sel]])
            est = ate.camera_centers(kf_pose[sel])
            gt = ate.camera_centers(seqs[a].T_cw[fr])
            span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
            acc = {"ate_rmse": round(ate.ate_rmse(est, gt), 4),
                   "span": round(span, 3), "server_kfs": len(sel)}
        if acc is not None:
            n_ok = sum(1 for s in states[a] if s == TrackState.OK)
            acc["frames_ok"] = n_ok
            if first_corr[a] is not None:
                acc["first_corr_frame"] = first_corr[a]
            out[f"agent{a}"] = acc
            ates.append(acc["ate_rmse"])
    if ates:
        out["ate_rmse"] = round(float(np.mean(ates)), 4)
    return out, server


def bench_gba(server=None, iters: int = 40) -> Dict:
    """Global-BA PCG iterations/s on the collaborative arena (the
    BASELINE.json "global BA iters/s" metric, one device). The observation
    list is the server's own assembly (CollabServer._assemble_gba), which
    masks the rows of invalid landmarks, cut to its valid rows; every
    valid keyframe is free (the JAX bench's gauge)."""
    from multi_orbslam3_tpu_torch.opt import global_ba
    if server is None:
        return {}
    m = server.m
    obs, K_obs, _, _, _ = server._assemble_gba()
    obs, K_obs = server._valid_rows(obs, K_obs)
    fixed = ~m.kf_valid
    run = lambda: global_ba.global_bundle_adjust(  # noqa: E731
        m.kf_pose, fixed, m.mp_pos, m.mp_valid, obs, K_obs,
        iters=2, cg_iters=iters // 2)
    run()                                       # first use
    _sync(server.device)
    t0 = time.perf_counter()
    run()
    _sync(server.device)
    wall = time.perf_counter() - t0
    return {"gba_iters_per_s": round(iters / wall, 2),
            "cg_iters": iters, "wall_s": round(wall, 3), "n_obs": int(obs.kf.shape[0])}


def bench_gba_large(n_kf: int = 1024, n_mp: int = 32768,
                    n_feat: int = 256, iters: int = 4,
                    cg_iters: int = 25, device=None) -> Dict:
    """Global-BA at production arena scale: >= 1024 KFs / >= 32k landmarks
    with realistic observation density (eval/gba_scaling.make_server_arena,
    4 agents), reporting PCG iterations/s, the server's verdict on each
    solve (an LM solve whose chi2 rose is rejected) and, on the card, the
    peak device memory since the arena was built."""
    from multi_orbslam3_tpu_torch.eval.gba_scaling import make_server_arena
    dev = devices.resolve(device, "bench_gba_large")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    server = make_server_arena(n_kf=n_kf, n_mp=n_mp, n_feat=n_feat,
                               n_agents=4, device=dev)
    n_obs = int(((server.m.kf_mp >= 0) & server.m.kf_feat_valid).sum())
    run = lambda: server.run_global_ba(  # noqa: E731
        iters=iters, cg_iters=cg_iters, distributed=False)
    run()                                           # first use
    _sync(dev)
    t0 = time.perf_counter()
    run()
    _sync(dev)
    wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(server.m.kf_pose).all()
                  and torch.isfinite(server.m.mp_pos[server.m.mp_valid]).all())
    out = {"n_kf": n_kf, "n_mp": n_mp, "n_obs": n_obs,
           "gba_iters_per_s": round(iters * cg_iters / wall, 2),
           "wall_s": round(wall, 3), "gba_runs": server.stats["gba_runs"],
           "gba_rejected": server.stats.get("gba_rejected", 0), "finite": finite}
    if dev.type == "cuda":
        out["peak_bytes_in_use"] = int(torch.cuda.max_memory_allocated(dev))
    return out


def bench_vocab_selectivity(n_worlds: int = 30, n_frames: int = 18,
                            seed0: int = 500, device=None) -> Dict:
    """Place-recognition selectivity: the bundled k10-L4 (10k words) vs
    k10-L5 (100k words) vocabularies on held-out worlds (seeds disjoint
    from the training corpus), at a multi-hundred-KF database size.
    Protocol: store every even frame of every world in one shared
    database; query with the odd frames; a query's true match is a stored
    frame of the same world within 2 frames. Reports top-1 recall and the
    mean true/false score margin per vocabulary."""
    from multi_orbslam3_tpu_torch.bow import database as dbm
    from multi_orbslam3_tpu_torch.bow import vocabulary as vocm
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.frontend import extractor

    dev = devices.resolve(device, "bench_vocab_selectivity")
    c = cfg.synthetic_mono()
    frames = []         # (world, frame_idx, desc, valid)
    for w in range(n_worlds):
        seq = synthetic.make_sequence(
            c, n_frames=n_frames, n_points=700, seed=seed0 + w,
            trajectory="circle" if w % 2 else "forward",
            phase=0.25 * (w % 6))
        for i in range(n_frames):
            f = extractor.extract_features(
                torch.from_numpy(np.asarray(seq.images[i], np.float32)).to(dev), c)
            frames.append((w, i, f.desc, f.valid))

    out: Dict = {"db_size": 0}
    for name, (b, L) in (("L4_10k", (10, 4)), ("L5_100k", (10, 5))):
        voc = vocm.default_vocabulary(b, L, device=dev)
        stored = [(w, i, d, v) for (w, i, d, v) in frames if i % 2 == 0]
        queries = [(w, i, d, v) for (w, i, d, v) in frames if i % 2 == 1]
        db = dbm.KeyframeDatabase.empty(len(stored), device=dev)
        meta = []
        for slot, (w, i, d, v) in enumerate(stored):
            db, _ = dbm.add_keyframe_bow(db, voc, slot, d, v)
            meta.append((w, i))
        meta = np.asarray(meta)
        none = torch.zeros(len(stored), dtype=torch.bool, device=dev)
        hits, margins = 0, []
        for (w, i, d, v) in queries:
            scores = _host(dbm.query(db, voc, d, v, none))
            top = int(np.argmax(scores))
            true_mask = (meta[:, 0] == w) & (np.abs(meta[:, 1] - i) <= 2)
            if true_mask[top]:
                hits += 1
            best_true = float(scores[true_mask].max()) \
                if true_mask.any() else 0.0
            best_false = float(scores[~true_mask].max()) \
                if (~true_mask).any() else 1e-9
            margins.append(best_true / max(best_false, 1e-9))
        out["db_size"] = len(stored)
        out[name] = {"top1_recall": round(hits / len(queries), 3),
                     "margin": round(float(np.mean(margins)), 3)}
    return out


def bench_mini_asl(n_frames: int = 80, seed: int = 41, device=None) -> Dict:
    """Scored EuRoC-layout drill: render a synthetic ground-truth
    sequence, write it as a miniature ASL tree (mav0/cam0 PNGs + csv,
    epoch-scale nanosecond stamps) with the port's writer, then run the
    real dataset-ingest path — euroc.EurocSequence -> bench_euroc — so
    loader, csv parsing, PNG decode and timestamp normalization are
    measured like a real EuRoC run (ros/launch/Client0_euroc.launch:6)."""
    device = devices.resolve(device, "bench_mini_asl")
    import shutil
    import tempfile
    from multi_orbslam3_tpu_torch.dataio import mini_asl, synthetic
    c = _euroc_scale_config()
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=1200,
                                  seed=seed, trajectory="forward")
    root = tempfile.mkdtemp(prefix="mini_asl_")
    try:
        mini_asl.write_mini_asl(root, seq)
        out = bench_euroc(root, n_frames=n_frames, device=device) or {}
        out["layout"] = "asl"
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bench_euroc(root: str, n_frames: int = 600, device=None) -> Optional[Dict]:
    """EuRoC mono run when a dataset directory exists (ASL layout).
    Ground truth from mav0/state_groundtruth_estimate0/data.csv. Beside
    the JAX package's keys, ``span``: the extent of the ground-truth
    positions of the OK frames, the yardstick of the ATE."""
    device = devices.resolve(device, "bench_euroc")
    import csv
    import os
    from multi_orbslam3_tpu_torch.dataio import euroc
    from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam, TrackState
    if not euroc.available(root):
        return None
    c = _euroc_scale_config()
    seq = euroc.EurocSequence(root, max_frames=n_frames)
    slam = MonoSlam(c, enable_loop_closing=True, device=device)
    states, ts_list = [], []
    t0 = time.perf_counter()
    for t, img in seq:
        states.append(slam.process_frame(img, t))
        ts_list.append(t)
    _sync(slam.device)
    wall = time.perf_counter() - t0
    out = {"fps": round(len(states) / wall, 2), "frames": len(states)}
    gt_path = os.path.join(root, "mav0", "state_groundtruth_estimate0",
                           "data.csv")
    if os.path.exists(gt_path):
        rows = []
        with open(gt_path) as f:
            for row in csv.reader(f):
                if row and not row[0].startswith("#"):
                    rows.append([float(x) for x in row[:8]])
        gt = np.asarray(rows)
        gt_t = gt[:, 0] * 1e-9
        ok_idx = [i for i, s in enumerate(states) if s == TrackState.OK]
        if len(ok_idx) >= 10:
            est = np.stack([slam.trajectory[i][1] for i in ok_idx])
            e = ate.camera_centers(est)
            g = np.stack([gt[np.argmin(np.abs(gt_t - ts_list[i])), 1:4]
                          for i in ok_idx])
            out["ate_rmse"] = round(ate.ate_rmse(e, g), 4)
            out["span"] = round(float(np.linalg.norm(g.max(0) - g.min(0))), 3)
            out["frames_ok"] = len(ok_idx)
    return out


def bench_kernels(device=None) -> Dict:
    """The two hand-written kernels against their plain PyTorch versions
    at the JAX package's micro-bench shapes (SURVEY §3.1): K1, FAST score +
    NMS of one 480x752 level of noise at threshold 20, and K2's Hamming
    matrix at 16,384 x 1,024. Checks that both give the same numbers and
    records which one the pipeline dispatches on this device (the kernel
    on a CUDA tensor, the plain version on a CPU one) and the mean ms of a
    call of each (synchronised after the loop)."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    dev = devices.resolve(device, "bench_kernels")
    out: Dict = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                 "dispatched": "cuda" if dev.type == "cuda" else "plain"}
    rng = np.random.RandomState(0)

    def timeit(fn, *args, n=30):
        fn(*args)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn(*args)
        _sync(dev)
        return (time.perf_counter() - t0) / n * 1e3, r

    img = torch.from_numpy(rng.uniform(0, 255, (480, 752)).astype(np.float32)).to(dev)
    out["fast_plain_ms"], ref = timeit(kernels.fast_score_nms_ref, img, 20.0)
    out["fast_kernel_ms"], got = timeit(kernels.fast_score_nms, img, 20.0)
    out["fast_equal"] = bool(torch.equal(got, ref))
    d1 = torch.from_numpy(rng.randint(0, 2 ** 32, (16384, 8), dtype=np.uint32)
                          .view(np.int32)).to(dev)
    d2 = torch.from_numpy(rng.randint(0, 2 ** 32, (1024, 8), dtype=np.uint32)
                          .view(np.int32)).to(dev)
    out["hamming_plain_ms"], ref = timeit(kernels.hamming_matrix_ref, d1, d2, n=5)
    out["hamming_kernel_ms"], got = timeit(kernels.hamming_matrix, d1, d2)
    out["hamming_equal"] = bool(torch.equal(got, ref))
    out["codec"] = _bench_codec(rng)
    return out


def _bench_codec(rng) -> Dict:
    """Wire-codec round-trip at vicinity-downlink scale (50 KFs), native
    C++ vs the pure-Python twin vs the old np.savez path. Both codec
    impls are memcpy-bound and equivalent (numpy's tobytes/frombuffer/
    crc32 are already C); the win over savez is the zero-copy decode +
    CRC integrity. Host only: no device work."""
    import io
    import json as _json

    from multi_orbslam3_tpu_torch.collab import codec
    arrays = {
        "uv": rng.rand(50, 1024, 2).astype(np.float32),
        "desc": rng.randint(0, 2 ** 32, (50, 1024, 8)).astype(np.uint32),
        "level": rng.randint(0, 8, (50, 1024)).astype(np.int32),
        "valid": rng.rand(50, 1024) > 0.2,
        "T": rng.rand(50, 4, 4).astype(np.float32),
    }
    meta = {"agent": 0, "seq": 1}

    def timeit_host(fn, n=50):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return round((time.perf_counter() - t0) / n * 1e3, 3)

    out: Dict = {"native_available": codec.native_available()}
    frame = codec.pack(meta, arrays)
    out["frame_mb"] = round(len(frame) / 2 ** 20, 2)
    out["rt_ms"] = timeit_host(lambda: codec.unpack(codec.pack(meta, arrays)))
    items = [(k.encode(), v) for k, v in arrays.items()]
    mb = _json.dumps(meta).encode()
    out["rt_py_ms"] = timeit_host(
        lambda: codec._unpack_py(codec._pack_py(mb, items)))

    def savez_rt():
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        with np.load(io.BytesIO(buf.getvalue())) as z:
            return {k: z[k] for k in z.files}
    out["rt_savez_ms"] = timeit_host(savez_rt)
    return out
