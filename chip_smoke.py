"""GPU smoke run of the PyTorch port (multi_orbslam3_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (an sm_90a part: H100/H200) and nvcc. Phases, each
printing one JSON line with its peak device memory and each fatal on
failure:

0. device: the card, its power limit, torch and CUDA versions;
1. build: compile the hand-written CUDA kernels from csrc/ (timed);
2. kernels: K1 (FAST score + NMS) at the 8 pyramid-level shapes of the
   752x480 bench camera, on a rendered frame's pyramid and on noise, and
   K2 (Hamming matrix) at 16384x1024, 1024x1024 and 16384x16384 (the loop
   closer's landmark-table match), each held against its plain PyTorch
   version (exact equality required), with kernel and plain times (median
   of CUDA-event timings, synchronised after each launch);
3. slice: bench_mono as the JAX package scores it: the port's MonoSlam
   with loop closing on (the default) and the bundled k=10 L=5 vocabulary
   on the bench sequence (752x480, 120 frames, 1500 landmarks, seed 5,
   forward), driven like eval/benchmarks.py::_drive_mono (warm-up pass,
   then a timed pass on a fresh system). Fails unless both kernels were
   launched, at least 100 of 120 frames track OK, ATE <= 0.02 x span and
   every adopted keyframe has a row in the loop closer's database. Prints
   loops, merges, relocalizations and the per-keyframe place-recognition
   time (loop_closing._pr_step, CUDA events);
4. slice_lc_off: the same sequence with loop closing off (the timed pass
   alone), with the gates of 3 but the database one;
5. relocalize: a fresh MonoSlam takes the final map of 3, switches to
   localization-only mode and replays frames 60-119: at least one
   relocalization, no keyframe or landmark added, > 60% of the frames OK,
   ATE < 0.1 x max(span, 1) (tests/test_localization_mode.py's gates);
6. atlas_loop: tests/test_multiloop.py's drill (640x480, 170 frames of a
   2.5 pi orbit, a +10 s timestamp jump at frame 80, synchronous mapping):
   a new sub-map starts, at least one loop closes, one map is left, the
   essential-graph audit passes and the keyframe ATE < 0.12 x max(span, 1).
   Prints the times of the verification cascade and its stages,
   correct_loop and weld_after_merge (CUDA events);
7. sync_free: one fused step, one mapping chain and one place-recognition
   step on the final map run under torch's sync debug mode "error": none
   reads the device back.

Kernel launch counts are reset just before each driven path (the timed
passes of 3 and 4, and 5 and 6) and read just after it; each fails unless
both kernels were launched. The last three lines of stdout are the card's
nvidia-smi name/power-limit line, a JSON summary of the kernels (launches
summed over those paths), and {"ok": true, "device": ...}. The script
imports nothing of JAX.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time

sys.modules["jax"] = None        # any JAX import below fails loudly

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_START = time.perf_counter()
KERNEL_SOURCES = {
    "fast_score_nms": ("multi_orbslam3_tpu_torch/csrc/fast_nms.cu",
                       "multi_orbslam3_tpu/frontend/pallas_kernels.py:116"),
    "hamming_matrix": ("multi_orbslam3_tpu_torch/csrc/hamming.cu",
                       "multi_orbslam3_tpu/frontend/pallas_kernels.py:169"),
}


def emit(phase: str, **kw) -> None:
    kw = {"phase": phase, "elapsed_s": round(time.perf_counter() - T_START, 3),
          **kw}
    if torch.cuda.is_available():
        kw["peak_mem_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    print(json.dumps(kw), flush=True)


def start_phase() -> None:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


class StageTimes:
    """CUDA-event spans around calls of loop_closing's stages: each call
    is wrapped by a start and an end event on the current stream; the
    spans are read once the phase has synchronised."""

    def __init__(self, module, names):
        self._module = module
        self._orig = {n: getattr(module, n) for n in names}
        self.events = collections.defaultdict(list)
        for n, fn in self._orig.items():
            setattr(module, n, self._wrap(n, fn))

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events[name].append((start, end))
            return out
        return timed

    def close(self) -> dict:
        """Restore the module; {name: {"calls", "ms_median", "ms"}}."""
        for n, fn in self._orig.items():
            setattr(self._module, n, fn)
        torch.cuda.synchronize()
        out = {}
        for n in self._orig:
            ms = [s.elapsed_time(e) for s, e in self.events[n]]
            out[n] = {"calls": len(ms),
                      "ms_median": float(np.median(ms)) if ms else None,
                      "ms": ms}
        return out


def cuda_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median device time of one call of fn, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def euroc_scale_config():
    """The bench_mono configuration (eval/benchmarks.py::_euroc_scale_config):
    EuRoC-sized pinhole camera with the default capacities (1024 ORB
    features over 8 levels, 512 keyframes, 16384 landmarks)."""
    from multi_orbslam3_tpu import config as cfg
    cam = cfg.CameraConfig(width=752, height=480, fx=458.654, fy=457.296,
                           cx=376.0, cy=240.0)
    return cfg.SystemConfig(camera=cam)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))
    return smi


def phase_build() -> None:
    from multi_orbslam3_tpu_torch.frontend import kernels
    t0 = time.perf_counter()
    info = kernels.build()
    kernels._lib()          # load and bind the library now, not mid-run
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         cached=info["cached"], ptxas=ptxas)


def phase_kernels(frame: np.ndarray, cfg) -> dict:
    from multi_orbslam3_tpu_torch.frontend import kernels, pyramid
    dev = torch.device("cuda")
    o = cfg.orb
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {}

    # K1 on the rendered frame's pyramid and on noise at every level shape
    levels = pyramid.build_pyramid(torch.from_numpy(frame).to(dev).float(),
                                   o.n_levels, o.scale_factor)
    k1_err, k1_rows = 0.0, []
    for lv, im in enumerate(levels):
        noise = torch.round(torch.rand(im.shape, generator=gen, device=dev) * 255.0)
        for name, img in (("frame", im.contiguous()), ("noise", noise)):
            got = kernels.fast_score_nms(img, o.fast_threshold_min)
            torch.cuda.synchronize()
            ref = kernels.fast_score_nms_ref(img, o.fast_threshold_min)
            if not torch.equal(got, ref):
                bad = int((got != ref).sum())
                raise AssertionError(f"K1 differs from its plain version at "
                                     f"level {lv} ({name}): {bad} pixels")
            k1_err = max(k1_err, float((got - ref).abs().max()))
        ms_k = cuda_ms(lambda: kernels.fast_score_nms(im, o.fast_threshold_min))
        ms_p = cuda_ms(lambda: kernels.fast_score_nms_ref(im, o.fast_threshold_min))
        k1_rows.append({"shape": list(im.shape), "ms": ms_k, "plain_ms": ms_p})
    emit("kernel_fast_score_nms", exact=True, levels=k1_rows)
    out["fast_score_nms"] = {"max_abs_err": k1_err, "ms": k1_rows[0]["ms"],
                             "plain_ms": k1_rows[0]["plain_ms"]}

    # K2 at the tracking shape (map x frame), the keyframe-pair shape and
    # the loop closer's landmark-table shape (map x map)
    k2_err, k2_rows = 0, []
    n_feat = o.n_features
    P = cfg.map.max_mappoints
    for n, m in ((P, n_feat), (n_feat, n_feat), (P, P)):
        d1 = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 8), generator=gen,
                           device=dev, dtype=torch.int64).to(torch.int32)
        d2 = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, 8), generator=gen,
                           device=dev, dtype=torch.int64).to(torch.int32)
        got = kernels.hamming_matrix(d1, d2)
        torch.cuda.synchronize()
        ref = kernels.hamming_matrix_ref(d1, d2)
        if not torch.equal(got, ref):
            raise AssertionError(f"K2 differs from its plain version at "
                                 f"{n}x{m}: {int((got != ref).sum())} entries")
        k2_err = max(k2_err, int((got - ref).abs().max()))
        del got, ref
        reps = 5 if n * m > 2 ** 26 else 15
        ms_k = cuda_ms(lambda: kernels.hamming_matrix(d1, d2), reps=reps)
        ms_p = cuda_ms(lambda: kernels.hamming_matrix_ref(d1, d2), reps=reps)
        k2_rows.append({"shape": [n, m], "ms": ms_k, "plain_ms": ms_p})
    emit("kernel_hamming_matrix", exact=True, shapes=k2_rows)
    out["hamming_matrix"] = {"max_abs_err": float(k2_err), "ms": k2_rows[0]["ms"],
                             "plain_ms": k2_rows[0]["plain_ms"]}
    return out


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def drive_mono(cfg, seq, device: str, loop_closing: bool,
               warmup: bool = True) -> tuple:
    """Warm-up pass, then a timed pass on a fresh system, as _drive_mono
    does; the next frame's upload is issued before the current frame."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam
    F = seq.images.shape[0]
    for timed in ((False, True) if warmup else (True,)):
        slam = MonoSlam(cfg, enable_loop_closing=loop_closing, device=device)
        if timed:
            sync(device)
            kernels.reset_launch_counts()
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
        sync(device)
        wall = time.perf_counter() - t0
    return slam, np.asarray(frame_ms), wall, kernels.launch_counts()


def phase_sync_free(cfg, slam, seq) -> None:
    """The fused step, the mapping chain and the place-recognition step
    launch their work without one device->host read: all run under
    torch's sync debug mode "error"."""
    from multi_orbslam3_tpu_torch.pipeline import local_mapping, loop_closing, tracking
    start_phase()
    img = slam.to_device(seq.images[-1])
    T_cur = slam._upload(slam.T_cur)
    T_vel = slam._upload(slam.T_vel)
    k = int(slam.m.n_kf) - 1
    lc = slam.loop_closer
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tracking.fused_step_chained(cfg, slam.m, img, T_cur, T_vel)
        local_mapping.map_keyframe(slam.m, k, slam.K,
                                   **local_mapping.mapping_kwargs(cfg))
        loop_closing._pr_step(lc.db, lc.voc, slam.m, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit("sync_free", fused_step_chained=True, map_keyframe=True, pr_step=True)


def ate_of(slam, seq, ok_idx, offset: int = 0, with_scale: bool = True) -> tuple:
    """(ATE RMSE, span) of the frames ok_idx of slam.trajectory against
    the sequence's frames ok_idx + offset."""
    from multi_orbslam3_tpu.eval import ate
    est = np.stack([slam.trajectory[i][1] for i in ok_idx])
    if not np.isfinite(est).all():
        raise AssertionError("non-finite poses in the trajectory")
    g = ate.camera_centers(seq.T_cw[np.asarray(ok_idx) + offset])
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    return float(ate.ate_rmse(ate.camera_centers(est), g, with_scale)), span


def check_launches(launches: dict, problems: list) -> None:
    for name, n in launches.items():
        if n <= 0:
            problems.append(f"kernel {name} was not launched on the main path")


def phase_slice(cfg, seq, loop_closing: bool, device: str = "cuda") -> tuple:
    """bench_mono through the port's MonoSlam, loop closing on (with a
    warm-up pass) or off (the timed pass alone)."""
    from multi_orbslam3_tpu_torch.pipeline import loop_closing as lcm
    from multi_orbslam3_tpu_torch.pipeline.system import TrackState
    name = "slice" if loop_closing else "slice_lc_off"
    start_phase()
    timer = (StageTimes(lcm, ["_pr_step", "verify_candidate_cascade"])
             if loop_closing else None)
    slam, frame_ms, wall, launches = drive_mono(cfg, seq, device, loop_closing,
                                                warmup=loop_closing)
    stages = timer.close() if timer else None
    F = seq.images.shape[0]
    states = [s for _, s in slam.frame_log]
    ok_idx = [i for i, s in enumerate(states) if s == TrackState.OK]
    ate_rmse, span = ate_of(slam, seq, ok_idx)
    res = {"frames": F, "frames_logged": len(states), "frames_ok": len(ok_idx),
           "kf_inserted": slam.stats["kf_inserted"],
           "mp_created": slam.stats["mp_created"],
           "mp_fused": slam.stats.get("mp_fused", 0),
           "relocalizations": slam.stats.get("relocalizations", 0),
           "maps_created": slam.stats.get("maps_created", 0),
           "map_resets": slam.stats.get("map_resets", 0),
           "ate_rmse": ate_rmse, "span": span, "ate_over_span": ate_rmse / span,
           "fps": F / wall, "wall_s": wall,
           "frame_ms_p50": float(np.percentile(frame_ms, 50)),
           # p90: the highest percentile with >= 10 of 120 frames beyond it
           "frame_ms_p90": float(np.percentile(frame_ms, 90)),
           "frame_ms_p99": float(np.percentile(frame_ms, 99)),
           "launches": launches}
    problems = []
    if loop_closing:
        lc = slam.loop_closer
        # the last keyframe may still sit in _pending_map, not yet adopted
        pending = slam._pending_map[1] if slam._pending_map is not None else -1
        n = int(slam.m.n_kf)
        valid = slam.m.kf_valid[:n].cpu().numpy()
        active = lc.db.active[:n].cpu().numpy()
        missing = [k for k in np.nonzero(valid)[0] if k != pending and not active[k]]
        res.update(loops_closed=lc.loops_closed, merges=lc.merges,
                   db_rows=int(active.sum()), pending_kf=int(pending),
                   pr_step_ms_median=stages["_pr_step"]["ms_median"],
                   pr_step_calls=stages["_pr_step"]["calls"],
                   pr_step_ms=stages["_pr_step"]["ms"],
                   cascades=stages["verify_candidate_cascade"]["calls"],
                   cascade_ms=stages["verify_candidate_cascade"]["ms"])
        if missing:
            problems.append(f"adopted keyframes without a database row: {missing}")
    emit(name, **res)
    if len(states) != F:
        problems.append(f"{len(states)} frames logged of {F}")
    check_launches(launches, problems)
    if len(ok_idx) < 100:
        problems.append(f"only {len(ok_idx)} of {F} frames tracked OK (< 100)")
    if not ate_rmse <= 0.02 * span:
        problems.append(f"ATE {ate_rmse:.4f} m > 0.02 x span {span:.3f} m")
    if problems:
        raise AssertionError(f"{name}: " + "; ".join(problems))
    return res, slam


def phase_relocalize(cfg, seq, mapper, device: str = "cuda") -> dict:
    """Localization-only replay of frames 60-119 against the final map of
    the slice run (tests/test_localization_mode.py at full width)."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam, TrackState
    start_phase()
    mapper._adopt_pending(force=True)
    loc = MonoSlam(cfg, device=device)
    loc.m = mapper.m
    loc.activate_localization_mode()
    n_kf0, n_mp0 = int(loc.m.n_kf), int(loc.m.n_mp)
    first, F = 60, seq.images.shape[0]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    states = [loc.process_frame(seq.images[i], float(seq.timestamps[i]))
              for i in range(first, F)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    ok = [j for j, st in enumerate(states) if st == TrackState.OK]
    ate_rmse, span = ate_of(loc, seq, ok, offset=first) if ok else (float("inf"), 0.0)
    res = {"frames": len(states), "frames_ok": len(ok),
           "relocalizations": loc.stats.get("relocalizations", 0),
           "first_ok": ok[0] + first if ok else None,
           "n_kf": int(loc.m.n_kf), "n_mp": int(loc.m.n_mp),
           "kf_inserted": loc.stats["kf_inserted"], "ate_rmse": ate_rmse,
           "span": span, "wall_s": wall, "launches": launches}
    emit("relocalize", **res)
    problems = []
    check_launches(launches, problems)
    if res["relocalizations"] < 1:
        problems.append("no relocalization")
    if (res["n_kf"], res["n_mp"], res["kf_inserted"]) != (n_kf0, n_mp0, 0):
        problems.append(f"the frozen map changed: {n_kf0}->{res['n_kf']} keyframes, "
                        f"{n_mp0}->{res['n_mp']} landmarks, "
                        f"{res['kf_inserted']} inserted")
    if not len(ok) > 0.6 * len(states):
        problems.append(f"only {len(ok)} of {len(states)} frames OK (<= 60%)")
    if not ate_rmse < 0.1 * max(span, 1.0):
        problems.append(f"ATE {ate_rmse:.4f} m >= 0.1 x max(span {span:.3f}, 1)")
    if problems:
        raise AssertionError("relocalize: " + "; ".join(problems))
    return res


def warm_torch_func(device: str) -> float:
    """Seconds of the first torch.func forward-mode calls in the process
    (the Sim3 refinement and the pose-graph Jacobians, on a few points):
    a one-time cost, paid here so that the stage times below are steady
    state."""
    from multi_orbslam3_tpu_torch.geometry import camera as cam
    from multi_orbslam3_tpu_torch.geometry import sim3
    from multi_orbslam3_tpu_torch.opt import pose_graph, sim3_solve
    sync(device)
    t0 = time.perf_counter()
    p = torch.rand((8, 3), device=device) + torch.tensor([0.0, 0.0, 3.0], device=device)
    uv = torch.rand((8, 2), device=device) * 100.0
    ones = torch.ones(8, device=device)
    has = ones > 0
    K = cam.PinholeK(*(torch.tensor(v, device=device) for v in (300.0, 300.0, 50.0, 50.0)))
    eye = torch.eye(4, device=device)
    sim3_solve.optimize_sim3_reprojection(sim3.identity(device=device), K, eye, eye, p,
                                          uv, has, p, uv, has, ones, ones, iters=1)
    S = sim3.stack(sim3.identity((2,), device=device))
    idx = torch.tensor([1, 0], device=device)
    pose_graph.edge_jacobians(pose_graph.make_edges(S, idx, idx.flip(0), ones[:2], has[:2]), S)
    sync(device)
    return time.perf_counter() - t0


def phase_atlas_loop(device: str = "cuda") -> dict:
    """tests/test_multiloop.py's drill on the card: two sub-maps that only
    place recognition can weld back together."""
    from multi_orbslam3_tpu import config as cfgm
    from multi_orbslam3_tpu.dataio import synthetic
    from multi_orbslam3_tpu.eval import ate
    from multi_orbslam3_tpu_torch.frontend import kernels
    from multi_orbslam3_tpu_torch.map import audit
    from multi_orbslam3_tpu_torch.opt import sim3_solve
    from multi_orbslam3_tpu_torch.pipeline import loop_closing as lcm
    from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam
    start_phase()
    c = cfgm.synthetic_mono()
    n_frames, jump = 170, 80
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=1200, seed=21,
                                  trajectory="circle", phase=1.1, arc=2.5 * np.pi)
    slam = MonoSlam(c, device=device)
    slam.defer_mapping = False
    first_use_s = warm_torch_func(device)
    # the cascade, its stages, the correction and the weld
    timers = (StageTimes(lcm, ["verify_candidate_cascade", "match_loop_landmarks",
                               "verify_loop", "guided_projection_count",
                               "correct_loop", "weld_after_merge", "_pr_step"]),
              StageTimes(sim3_solve, ["optimize_sim3_reprojection"]))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(n_frames):
        slam.process_frame(seq.images[i], float(seq.timestamps[i])
                           + (10.0 if i >= jump else 0.0))
    slam._adopt_pending(force=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    stages = {k: v for t in timers for k, v in t.close().items()}
    valid = slam.m.kf_valid.cpu().numpy()
    map_ids = np.unique(slam.m.kf_map_id.cpu().numpy()[valid])
    graph = audit.check_essential_graph(slam.m)
    frames, poses = [], []
    for ts, T in slam.keyframe_trajectory():
        fr = int(round((ts - 10.0 if ts > 5.0 else ts) * 20.0))
        if 0 <= fr < n_frames:
            frames.append(fr)
            poses.append(T)
    gt = ate.camera_centers(seq.T_cw[frames])
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    ate_rmse = float(ate.ate_rmse(ate.camera_centers(np.stack(poses)), gt))
    lc = slam.loop_closer
    res = {"frames": n_frames, "maps_created": slam.stats.get("maps_created", 0),
           "loops_closed": lc.loops_closed, "merges": lc.merges,
           "map_ids": map_ids.tolist(), "kf_traj": len(poses),
           "kf_inserted": slam.stats["kf_inserted"], "audit": graph,
           "ate_rmse": ate_rmse, "span": span, "wall_s": wall, "launches": launches,
           "torch_func_first_use_s": first_use_s, "stages": stages}
    emit("atlas_loop", **res)
    problems = []
    check_launches(launches, problems)
    if res["maps_created"] < 1:
        problems.append("the timestamp jump started no new sub-map")
    if lc.loops_closed < 1:
        problems.append("place recognition never welded the sub-maps")
    if len(map_ids) != 1:
        problems.append(f"{len(map_ids)} sub-maps left: {map_ids.tolist()}")
    if len(poses) < 15:
        problems.append(f"only {len(poses)} keyframes in the final trajectory")
    if not ate_rmse < 0.12 * max(span, 1.0):
        problems.append(f"keyframe ATE {ate_rmse:.4f} m >= 0.12 x max(span {span:.3f}, 1)")
    if problems:
        raise AssertionError("atlas_loop: " + "; ".join(problems))
    return res


def main() -> int:
    smi = phase_device()
    phase_build()
    from multi_orbslam3_tpu.dataio import synthetic
    cfg = euroc_scale_config()
    t0 = time.perf_counter()
    seq = synthetic.make_sequence(cfg, n_frames=120, n_points=1500, seed=5,
                                  trajectory="forward")
    emit("sequence", frames=int(seq.images.shape[0]),
         shape=list(seq.images.shape[1:]),
         seconds=round(time.perf_counter() - t0, 3))
    frame0 = np.clip(np.round(seq.images[0]), 0, 255).astype(np.uint8)
    start_phase()
    kstats = phase_kernels(frame0, cfg)
    res, slam = phase_slice(cfg, seq, loop_closing=True)
    res_off, _ = phase_slice(cfg, seq, loop_closing=False)
    res_reloc = phase_relocalize(cfg, seq, slam)
    res_atlas = phase_atlas_loop()
    phase_sync_free(cfg, slam, seq)
    paths = (res, res_off, res_reloc, res_atlas)
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
         "replaces": KERNEL_SOURCES[name][1],
         "launches": sum(r["launches"][name] for r in paths), **kstats[name]}
        for name in ("fast_score_nms", "hamming_matrix")]}
    print(smi, flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
