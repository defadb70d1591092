"""GPU smoke run of the PyTorch port (multi_orbslam3_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (an sm_90a part: H100/H200) and nvcc. Phases, each
printing one JSON line and each fatal on failure:

0. device: the card, its power limit, torch and CUDA versions;
1. build: compile the hand-written CUDA kernels from csrc/ (timed);
2. kernels: K1 (FAST score + NMS) at the 8 pyramid-level shapes of the
   752x480 bench camera, on a rendered frame's pyramid and on noise, and
   K2 (Hamming matrix) at 16384x1024 and 1024x1024, each held against its
   plain PyTorch version (exact equality required), with kernel and plain
   times (median of CUDA-event timings, synchronised after each launch);
3. slice: the port's MonoSlam (loop closing off) on the bench_mono
   sequence (752x480, 120 frames, 1500 landmarks, seed 5, forward), driven
   like eval/benchmarks.py::_drive_mono (warm-up pass, then a timed pass on
   a fresh system). Kernel launch counts are reset just before the timed
   pass and read just after it. Fails unless both kernels were launched,
   at least 100 of 120 frames track OK and ATE <= 0.02 x span;
4. sync_free: one fused step and one mapping chain on the final map run
   under torch's sync debug mode "error": neither reads the device back.

The last three lines of stdout are the card's nvidia-smi name/power-limit
line, a JSON summary of the kernels, and {"ok": true, "device": ...}.
The script imports nothing of JAX.
"""

from __future__ import annotations

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
    print(json.dumps(kw), flush=True)


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

    # K2 at the tracking shape (map x frame) and the keyframe-pair shape
    k2_err, k2_rows = 0, []
    n_feat = o.n_features
    for n, m in ((cfg.map.max_mappoints, n_feat), (n_feat, n_feat)):
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
        ms_k = cuda_ms(lambda: kernels.hamming_matrix(d1, d2))
        ms_p = cuda_ms(lambda: kernels.hamming_matrix_ref(d1, d2))
        k2_rows.append({"shape": [n, m], "ms": ms_k, "plain_ms": ms_p})
    emit("kernel_hamming_matrix", exact=True, shapes=k2_rows)
    out["hamming_matrix"] = {"max_abs_err": float(k2_err), "ms": k2_rows[0]["ms"],
                             "plain_ms": k2_rows[0]["plain_ms"]}
    return out


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def drive_mono(cfg, seq, device: str) -> tuple:
    """Warm-up pass, then a timed pass on a fresh system, as _drive_mono
    does; the next frame's upload is issued before the current frame."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam
    F = seq.images.shape[0]
    for timed in (False, True):
        slam = MonoSlam(cfg, enable_loop_closing=False, device=device)
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
    """The fused step and the mapping chain launch their work without one
    device->host read: both run under torch's sync debug mode "error"."""
    from multi_orbslam3_tpu_torch.pipeline import local_mapping, tracking
    img = slam.to_device(seq.images[-1])
    T_cur = slam._upload(slam.T_cur)
    T_vel = slam._upload(slam.T_vel)
    k = int(slam.m.n_kf) - 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tracking.fused_step_chained(cfg, slam.m, img, T_cur, T_vel)
        local_mapping.map_keyframe(slam.m, k, slam.K,
                                   **local_mapping.mapping_kwargs(cfg))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit("sync_free", fused_step_chained=True, map_keyframe=True)


def phase_slice(cfg, seq, device: str = "cuda") -> dict:
    from multi_orbslam3_tpu.eval import ate
    from multi_orbslam3_tpu_torch.pipeline.system import TrackState
    slam, frame_ms, wall, launches = drive_mono(cfg, seq, device)
    F = seq.images.shape[0]
    states = [s for _, s in slam.frame_log]
    ok_idx = [i for i, s in enumerate(states) if s == TrackState.OK]
    est = np.stack([slam.trajectory[i][1] for i in ok_idx])
    if not np.isfinite(est).all():
        raise AssertionError("non-finite poses in the trajectory")
    e = ate.camera_centers(est)
    g = ate.camera_centers(seq.T_cw[ok_idx])
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    ate_rmse = float(ate.ate_rmse(e, g, True))
    res = {"frames": F, "frames_logged": len(states), "frames_ok": len(ok_idx),
           "kf_inserted": slam.stats["kf_inserted"],
           "mp_created": slam.stats["mp_created"],
           "mp_fused": slam.stats.get("mp_fused", 0),
           "ate_rmse": ate_rmse, "span": span, "ate_over_span": ate_rmse / span,
           "fps": F / wall, "wall_s": wall,
           "frame_ms_p50": float(np.percentile(frame_ms, 50)),
           # p90: the highest percentile with >= 10 of 120 frames beyond it
           "frame_ms_p90": float(np.percentile(frame_ms, 90)),
           "frame_ms_p99": float(np.percentile(frame_ms, 99)),
           "peak_mem_mib": (torch.cuda.max_memory_allocated() / 2 ** 20
                            if device == "cuda" else None),
           "launches": launches}
    emit("slice", **res)
    problems = []
    if len(states) != F:
        problems.append(f"{len(states)} frames logged of {F}")
    for name, n in launches.items():
        if n <= 0:
            problems.append(f"kernel {name} was not launched on the main path")
    if len(ok_idx) < 100:
        problems.append(f"only {len(ok_idx)} of {F} frames tracked OK (< 100)")
    if not ate_rmse <= 0.02 * span:
        problems.append(f"ATE {ate_rmse:.4f} m > 0.02 x span {span:.3f} m")
    if problems:
        raise AssertionError("; ".join(problems))
    return res, slam


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
    kstats = phase_kernels(frame0, cfg)
    res, slam = phase_slice(cfg, seq)
    phase_sync_free(cfg, slam, seq)
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
         "replaces": KERNEL_SOURCES[name][1],
         "launches": res["launches"][name], **kstats[name]}
        for name in ("fast_score_nms", "hamming_matrix")]}
    print(smi, flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
