"""GPU smoke run of the PyTorch port (multi_orbslam3_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (an sm_90a part: H100/H200) and nvcc. Phases, each
printing one JSON line with its peak device memory and each fatal on
failure:

0. device: the card, its power limit and clocks, torch and CUDA versions;
1. build: compile the hand-written CUDA kernels from csrc/ (one nvcc a
   source, in parallel; timed);
2. kernels: every kernel against its plain PyTorch version, exact equality
   required (integers, comparisons, min/max only: tolerance 0):
   - K1 (FAST score + NMS) level by level at the 8 pyramid-level shapes of
     the 752x480 bench camera and as ONE launch for the whole pyramid, on
     a rendered frame and on noise;
   - K2 as a matrix at 16384x1024, 1024x1024 and 16384x16384;
   - K2's fused matches, which write no N x M: the validity-masked one
     (both inner products, __popc and the 1-bit tensor-core MMA) at the
     same three shapes, the projection-masked one at 16384x1024 and
     1024x1024, and the stereo-masked one at 1024x1024 (also on a case
     that puts pairs exactly on the row tolerance and the disparity
     limits), on random descriptors with about 25% of rows and columns
     invalid and on a tie case (every 7th descriptor duplicated, one
     fully masked row and column); the inner products are also timed with
     every row and column valid and, at 16384x16384, with about 4% valid
     (the loop closer's masks); the matchers are checked to allocate no
     N x M tensor.
   Each row has call_ms (median time of one call between CUDA events,
   host launch latency included), device_ms (the kernel's own duration:
   torch.profiler's device self time over 50 launches, or 50 launches
   replayed from a CUDA graph if the profiler shows none), plain_ms, and
   bound_ms: the least time the card could take, from this run's inputs
   (bytes over 3.35 TB/s; popcounts over 16 a clock an SM; float
   add/multiply over 128 and min/max/compare over 64 a clock an SM;
   1-bit MMA steps at the int8 tensor rate), with the limit that binds. No single PyTorch call
   computes either function, so library_ms is null;
3. slice: bench_mono as the JAX package scores it: the port's MonoSlam
   with loop closing on (the default) and the bundled k=10 L=5 vocabulary
   on the bench sequence (752x480, 120 frames, 1500 landmarks, seed 5,
   forward), driven like eval/benchmarks.py::_drive_mono (warm-up pass,
   then a timed pass on a fresh system). Fails unless K1 was launched once
   a frame and both fused K2 kernels were launched, at least 100 of 120
   frames track OK, ATE <= 0.02 x span and every adopted keyframe has a
   row in the loop closer's database. Prints loops, merges,
   relocalizations and the per-keyframe place-recognition time
   (loop_closing._pr_step, CUDA events);
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
7. stereo: bench_stereo as the JAX package scores it (baseline 0.11 m, 80
   frames, 1200 landmarks, seed 9): StereoSlam with loop closing on
   through process_frame_stereo_pipelined. State OK at the end, >= 70
   frames OK, ATE without scale alignment <= 0.02 x span, K1 and the
   stereo match launched once a frame;
8. rgbd: the same sequence's depth images through RGBDSlam, 40 frames:
   state OK, >= 35 OK, ATE <= 0.08 x span;
9. mono_inertial (this and the next phase under torch's deterministic
   algorithms, see `reproducible`): bench_mono_inertial (EuRoC's T_bc, 90
   frames, 1200 landmarks, seed 7, lateral sway): IMU initialized, init scale in
   (0.05, 50), >= 8 keyframes evaluated after the init frame, keyframe ATE
   <= 0.1 x span; prints the ms per frame of preintegration, VI pose
   optimisation and the window BA (CUDA events);
10. stereo_inertial: tests/test_stereo_inertial.py's drill at bench width,
   50 frames: IMU initialized, scale 1 +- 1e-5, ATE <= 0.1 x max(span, 1);
   then RGBDInertialSlam for 20 frames: state OK;
11. sync_free: one fused step (mono and stereo), one mapping chain and one
   place-recognition step on the final map run under torch's sync debug
   mode "error": none reads the device back.

Kernel launch counts are reset just before each driven path (the timed
passes of 3 and 4, and 5 to 10) and read just after it; each fails unless
K1 and a K2 kernel were launched. The last three lines of stdout are the
card's nvidia-smi name/power-limit line, a JSON summary of the kernels
(one entry for each TPU kernel, its variants beneath it, launches summed
over those paths), and {"ok": true, "device": ...}. The script imports
torch, numpy, the standard library and the port: nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import json
import subprocess
import sys
import time

sys.modules["jax"] = None        # any import of JAX or of the JAX package
sys.modules["multi_orbslam3_tpu"] = None     # below fails loudly

import numpy as np  # noqa: E402
import torch  # noqa: E402

T_START = time.perf_counter()
# one entry for each TPU kernel: source, the TPU kernel it replaces, and
# its variants as (launch counter, source)
KERNELS = {
    "fast_score_nms": {
        "source": "multi_orbslam3_tpu_torch/csrc/fast_nms.cu",
        "replaces": "multi_orbslam3_tpu/frontend/pallas_kernels.py:116",
        "headline": "fast_score_nms_levels",
        "variants": {"fast_score_nms_levels": "multi_orbslam3_tpu_torch/csrc/fast_nms.cu"}},
    "hamming_matrix": {
        "source": "multi_orbslam3_tpu_torch/csrc/hamming.cu",
        "replaces": "multi_orbslam3_tpu/frontend/pallas_kernels.py:169",
        "headline": "hamming_best_two_projection",
        "variants": {
            "hamming_matrix": "multi_orbslam3_tpu_torch/csrc/hamming.cu",
            "hamming_best_two_valid_popc": "multi_orbslam3_tpu_torch/csrc/hamming.cu",
            "hamming_best_two_valid_mma": "multi_orbslam3_tpu_torch/csrc/hamming_mma.cu",
            "hamming_best_two_projection": "multi_orbslam3_tpu_torch/csrc/hamming.cu",
            "hamming_best_two_stereo": "multi_orbslam3_tpu_torch/csrc/hamming.cu"}},
}

# Peak rates the bounds are taken against (one H100 SXM): HBM bytes/s from
# the data sheet; __popc results, float32 add/multiply and float32 min/max
# or compare instructions per clock per SM from the arithmetic-throughput
# table of NVIDIA's CUDA documentation for compute capability 9.0 (the
# data sheet's 67 TFLOP/s is 128 FMA a clock an SM, an FMA counted as 2);
# the 1-bit MMA is given the int8 tensor rate by operand bytes (a k=256
# step of 1-bit operands moves what a k=32 step of int8 does), since no
# 1-bit peak is published.
HBM_BYTES_PER_S = 3.35e12
POPC_PER_CLK_SM = 16
FP32_INSTR_PER_CLK_SM = 128
MINMAX_PER_CLK_SM = 64
INT8_TENSOR_OPS_PER_S = 1979e12


def emit(phase: str, **kw) -> None:
    kw = {"phase": phase, "elapsed_s": round(time.perf_counter() - T_START, 3),
          **kw}
    if torch.cuda.is_available():
        kw["peak_mem_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    print(json.dumps(kw), flush=True)


def start_phase() -> None:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


@contextlib.contextmanager
def reproducible():
    """Run the block under torch's deterministic algorithms (warn only).

    The port's normal equations are summed with index_add, which on a GPU
    adds with float atomics in whatever order the threads arrive. The
    monocular-inertial estimator amplifies that last-bit noise: between the
    first inertial initialisation and its refinement two seconds later the
    map's scale is 10-30% off (as in the JAX package, whose refinement
    reports 0.82), the inertial factor disagrees with vision, and runs of
    the same code end anywhere from 0.013 to 0.105 x span. XLA's scatter-add
    keeps one order, so the JAX package gives one result a build; this
    switch gives the port the same property for the inertial phases, whose
    gates are then checked on a result that repeats. (The port works on one
    stream, so cuBLAS keeps one order without a fixed workspace: the result
    is the same digits with and without CUBLAS_WORKSPACE_CONFIG.)"""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


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


def call_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median time of one call of fn between two CUDA events, synchronised
    after each call: for a kernel of a few microseconds this is the host's
    launch latency, not the kernel's duration (see device_ms)."""
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


def device_ms(fn, kernel_name: str, launches: int = 50) -> tuple:
    """(ms, how): the mean duration of the kernel whose name contains
    kernel_name over `launches` calls of fn. From torch.profiler's device
    self time of that kernel; if the profiler shows no device time, from a
    CUDA graph of the calls replayed between two events (which also counts
    the wrapper's other small kernels and the gaps between launches)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel_name in evt.key:
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            if us > 0:
                total_us += us
                count += evt.count
    if count >= launches:
        return total_us / count / 1e3, "profiler"
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches, "cuda_graph"


def device_launches(fn) -> int:
    """Kernels and device copies that one call of fn launches, counted by
    torch.profiler (0 if the profiler shows no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = 0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            n += evt.count
    return n


def bound(card: dict, nbytes: float, popc: float = 0.0, fp32_instr: float = 0.0,
          minmax_instr: float = 0.0, mma_int8_ops: float = 0.0) -> dict:
    """The least time the card could take: the largest of the bytes over
    the HBM rate and each kind of operation over its peak rate."""
    clk = card["sm_count"] * card["max_sm_clock_hz"]
    limits = {"bytes": nbytes / HBM_BYTES_PER_S,
              "popcount rate": popc / (POPC_PER_CLK_SM * clk),
              "float ops": (fp32_instr / FP32_INSTR_PER_CLK_SM
                            + minmax_instr / MINMAX_PER_CLK_SM) / clk,
              "1-bit MMA at the int8 tensor rate": mma_int8_ops / INT8_TENSOR_OPS_PER_S}
    limit = max(limits, key=limits.get)
    return {"bound_ms": limits[limit] * 1e3,
            "bound_by": "bytes" if limit == "bytes" else "operations",
            "limit": limit}


# EuRoC cam0 body-from-camera extrinsics (eval/benchmarks.py::EUROC_T_BC)
EUROC_T_BC = (
    0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
    0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
    -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
    0.0, 0.0, 0.0, 1.0)


def euroc_scale_config(**camera_kw):
    """The bench configuration (eval/benchmarks.py::_euroc_scale_config):
    EuRoC-sized pinhole camera with the default capacities (1024 ORB
    features over 8 levels, 512 keyframes, 16384 landmarks)."""
    from multi_orbslam3_tpu_torch import config as cfg
    cam = cfg.CameraConfig(width=752, height=480, fx=458.654, fy=457.296,
                           cx=376.0, cy=240.0, **camera_kw)
    return cfg.SystemConfig(camera=cam)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    max_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = {"smi": smi, "max_sm_clock_hz": float(max_clock) * 1e6,
            "sm_count": torch.cuda.get_device_properties(0).multi_processor_count}
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         sm_count=card["sm_count"], max_sm_clock_mhz=float(max_clock),
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))
    return card


def phase_build() -> None:
    from multi_orbslam3_tpu_torch.frontend import kernels
    t0 = time.perf_counter()
    info = kernels.build()
    kernels._lib()          # load and bind the library now, not mid-run
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         cached=info["cached"], ptxas=ptxas)


def require_equal(name: str, got, want) -> None:
    """Tolerance 0: every kernel here is integers, comparisons, min/max."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{name} differs from its plain version in output "
                                 f"{i}: {int((g != w).sum())} of {g.numel()} entries")


def compass_pass_count(levels, threshold: float) -> tuple:
    """(interior pixels, pixels that need K1's arc search) of these levels:
    those with at least 2 of the 4 compass pixels of the radius-3 circle
    beyond the threshold on one side."""
    interior = passing = 0
    for im in levels:
        c = im[3:-3, 3:-3]
        d = torch.stack([im[6:, 3:-3] - c, im[3:-3, 6:] - c,
                         im[:-6, 3:-3] - c, im[3:-3, :-6] - c])
        need = ((d > threshold).sum(0) >= 2) | ((-d > threshold).sum(0) >= 2)
        interior += c.numel()
        passing += int(need.sum())
    return interior, passing


def random_words(n: int, gen, dev) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 8), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.int32)


def match_case(n: int, m: int, gen, dev, kind: str, width: int, height: int) -> dict:
    """Inputs of both fused matches at n x m. kind "random": random
    descriptors, about 25% of rows and columns invalid; "ties": also every
    7th column a copy of its left neighbour (descriptor and position),
    every 5th row a copy of a column, one fully masked row and column;
    "full": random, everything valid; "sparse": random, about 4% of rows
    and columns valid (the loop closer's landmark regions at map x map).
    Positions lie on a half-pixel grid in
    the image, the projections near features, so that pairs exactly on the
    radius occur."""
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    d1, d2 = random_words(n, gen, dev), random_words(m, gen, dev)
    keep = {"full": 1.0, "sparse": 0.04}.get(kind, 0.75)
    v1, v2 = rnd(n) < keep, rnd(m) < keep
    feat_uv = torch.round(rnd(m, 2) * torch.tensor([width, height], device=dev) * 2) / 2
    src = torch.randint(0, m, (n,), generator=gen, device=dev)
    if kind == "ties":
        k = d2[7::7].shape[0]
        d2[7::7] = d2[6:-1:7][:k].clone()
        feat_uv[7::7] = feat_uv[6:-1:7][:k].clone()
        d1[::5] = d2[src][::5]
        v1[min(3, n - 1)] = False
        v2[min(2, m - 1)] = False
    proj_uv = feat_uv[src] + torch.round(torch.randn((n, 2), generator=gen, device=dev) * 12) / 2
    radius = torch.tensor([2.5, 5.0, 6.5, 10.0, 15.0], device=dev)[
        torch.randint(0, 5, (n,), generator=gen, device=dev)]
    level = lambda k: torch.randint(0, 8, (k,), generator=gen, device=dev).to(torch.int32)
    return {"valid": (d1, v1, d2, v2),
            "projection": dict(mp_desc=d1, proj_uv=proj_uv, proj_valid=v1, radius=radius,
                               pred_level=level(n), feat_desc=d2, feat_uv=feat_uv,
                               feat_valid=v2, feat_level=level(m), level_slack=1)}


def k2_shapes(cfg) -> tuple:
    """Tracking (map x frame), keyframe-pair and loop-closer (map x map)."""
    n_feat, P = cfg.orb.n_features, cfg.map.max_mappoints
    return (P, n_feat), (n_feat, n_feat), (P, P)


def check_k1(frame: np.ndarray, frame_right: np.ndarray, cfg, card: dict, gen) -> dict:
    """K1 level by level, as one launch for the pyramid, and as one launch
    for the two pyramids of a stereo frame."""
    from multi_orbslam3_tpu_torch.frontend import kernels, pyramid
    dev = torch.device("cuda")
    o = cfg.orb
    thr = o.fast_threshold_min
    levels = [im.contiguous() for im in pyramid.build_pyramid(
        torch.from_numpy(frame).to(dev).float(), o.n_levels, o.scale_factor)]
    noise = [torch.round(torch.rand(im.shape, generator=gen, device=dev) * 255.0)
             for im in levels]
    per_level = []
    for lv, (im, nz) in enumerate(zip(levels, noise)):
        for img in (im, nz):
            got = kernels.fast_score_nms(img, thr)
            torch.cuda.synchronize()
            require_equal(f"K1 level {lv}", [got], [kernels.fast_score_nms_ref(img, thr)])
        ms, how = device_ms(lambda: kernels.fast_score_nms(im, thr),
                            "fast_score_nms_levels_kernel")
        per_level.append({
            "shape": list(im.shape), "device_ms": ms, "device_ms_from": how,
            "call_ms": call_ms(lambda: kernels.fast_score_nms(im, thr)),
            "plain_ms": call_ms(lambda: kernels.fast_score_nms_ref(im, thr))})
    k1 = {}
    for name, lvls in (("frame", levels), ("noise", noise)):
        got = kernels.fast_score_nms_levels(lvls, thr)
        torch.cuda.synchronize()
        want = kernels.fast_score_nms_levels_ref(lvls, thr)
        require_equal(f"K1 all levels ({name})", got, want)
        corners = sum(int((g > 0).sum()) for g in got)
        if corners == 0:
            raise AssertionError(f"K1 found no corner on the {name} pyramid")
        interior, passing = compass_pass_count(lvls, thr)
        pixels = sum(im.numel() for im in lvls)
        ms, how = device_ms(lambda: kernels.fast_score_nms_levels(lvls, thr),
                            "fast_score_nms_levels_kernel")
        k1[name] = {
            "shape": [list(im.shape) for im in lvls], "corners": corners,
            "arc_search_share": passing / interior,
            "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got, want)),
            "device_ms": ms, "device_ms_from": how,
            "call_ms": call_ms(lambda: kernels.fast_score_nms_levels(lvls, thr)),
            "plain_ms": call_ms(lambda: kernels.fast_score_nms_levels_ref(lvls, thr)),
            "library_ms": None,
            # a pixel: 16 differences and 8 compass compares; 158 min/max
            # more where the arc search runs
            **bound(card, 8.0 * pixels, fp32_instr=16.0 * interior,
                    minmax_instr=8.0 * interior + 158.0 * passing)}
    # a stereo frame: the 8 + 8 levels of both images in one launch
    right = [im.contiguous() for im in pyramid.build_pyramid(
        torch.from_numpy(frame_right).to(dev).float(), o.n_levels, o.scale_factor)]
    both = levels + right
    got = kernels.fast_score_nms_levels(both, thr)
    torch.cuda.synchronize()
    require_equal("K1 stereo pair", got,
                  kernels.fast_score_nms_levels(levels, thr)
                  + kernels.fast_score_nms_levels(right, thr))
    interior, passing = compass_pass_count(both, thr)
    ms, how = device_ms(lambda: kernels.fast_score_nms_levels(both, thr),
                        "fast_score_nms_levels_kernel")
    pair = {"levels": len(both), "device_ms": ms, "device_ms_from": how,
            "call_ms": call_ms(lambda: kernels.fast_score_nms_levels(both, thr)),
            **bound(card, 8.0 * sum(im.numel() for im in both),
                    fp32_instr=16.0 * interior,
                    minmax_instr=8.0 * interior + 158.0 * passing)}
    emit("kernel_fast_score_nms", exact=True, per_level=per_level,
         per_level_device_ms_sum=sum(r["device_ms"] for r in per_level), all_levels=k1,
         stereo_pair=pair)
    return {"fast_score_nms_levels": dict(k1["frame"], on_noise=k1["noise"],
                                          stereo_pair=pair)}



def check_k2_matrix(cfg, card: dict, gen) -> dict:
    """K2 as a matrix."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    dev = torch.device("cuda")
    shapes = k2_shapes(cfg)
    matrix_rows = []
    for n, m in shapes:
        d1, d2 = random_words(n, gen, dev), random_words(m, gen, dev)
        got = kernels.hamming_matrix(d1, d2)
        torch.cuda.synchronize()
        ref = kernels.hamming_matrix_ref(d1, d2)
        require_equal(f"K2 matrix {n}x{m}", [got], [ref])
        err = int((got - ref).abs().max())
        del got, ref
        reps = 5 if n * m > 2 ** 26 else 15
        ms, how = device_ms(lambda: kernels.hamming_matrix(d1, d2), "hamming_matrix_kernel",
                            launches=50 if n * m <= 2 ** 26 else 10)
        matrix_rows.append({
            "shape": [n, m], "max_abs_err": float(err), "device_ms": ms,
            "device_ms_from": how,
            "call_ms": call_ms(lambda: kernels.hamming_matrix(d1, d2), reps=reps),
            "plain_ms": call_ms(lambda: kernels.hamming_matrix_ref(d1, d2), reps=reps),
            "library_ms": None,
            **bound(card, 32.0 * (n + m) + 4.0 * n * m, popc=8.0 * n * m)})
    emit("kernel_hamming_matrix", exact=True, shapes=matrix_rows)
    return {"hamming_matrix": dict(matrix_rows[0], shapes=matrix_rows)}



def check_k2_fused(cfg, card: dict, gen) -> dict:
    """K2's fused matches: exactness on random and tie cases, then times."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    dev = torch.device("cuda")
    shapes = k2_shapes(cfg)
    P = cfg.map.max_mappoints
    W, H = cfg.camera.width, cfg.camera.height
    valid_rows = {"popc": [], "mma": []}
    proj_rows = []
    for n, m in shapes:
        block = 2048 if n * m > 2 ** 26 else None     # bounds the plain version's memory
        for kind in ("random", "ties", "full") + (("sparse",) if n == m == P else ()):
            case = match_case(n, m, gen, dev, kind, W, H)
            d1, v1, d2, v2 = case["valid"]
            want = kernels.hamming_best_two_valid_ref(d1, v1, d2, v2, row_block=block)
            n_valid = float(v1.sum()) * float(v2.sum())
            for inner in ("popc", "mma"):
                fn = lambda: kernels.hamming_best_two_valid(d1, v1, d2, v2, inner=inner)
                got = fn()
                torch.cuda.synchronize()
                require_equal(f"K2 valid/{inner} {n}x{m} ({kind})", got, want)
                if kind == "ties":
                    continue
                ms, how = device_ms(fn, f"best_two_{inner}_kernel",
                                    launches=50 if n * m <= 2 ** 26 else 10)
                io_bytes = 33.0 * (n + m) + 16.0 * n + 24.0 * m
                ops = ({"popc": 8.0 * n_valid} if inner == "popc"
                       else {"mma_int8_ops": 64.0 * n_valid})
                valid_rows[inner].append({
                    "shape": [n, m], "inputs": kind, "valid_pairs": n_valid,
                    "max_abs_err": 0.0, "device_ms": ms, "device_ms_from": how,
                    "call_ms": call_ms(fn, reps=5),
                    "plain_ms": (call_ms(lambda: kernels.hamming_best_two_valid_ref(
                        d1, v1, d2, v2, row_block=block), reps=3, warmup=1)
                        if kind == "random" else None),
                    "library_ms": None, **bound(card, io_bytes, **ops)})
            if n * m > 2 ** 26:
                continue                      # no projection match at map x map
            c = case["projection"]
            pfn = lambda: kernels.hamming_best_two_projection(**c)
            got = pfn()
            torch.cuda.synchronize()
            want = kernels.hamming_best_two_projection_ref(**c)
            require_equal(f"K2 projection {n}x{m} ({kind})", got, want)
            matched = int((got[1] < kernels.BIG).sum())
            if matched == 0:
                raise AssertionError(f"K2 projection {n}x{m} ({kind}): nothing in any window")
            if kind == "ties":
                continue
            # pairs that pass the window, from the plain mask
            d2p = torch.sum((c["proj_uv"][:, None, :] - c["feat_uv"][None, :, :]) ** 2, dim=-1)
            passing = float(((d2p <= c["radius"][:, None] ** 2)
                             & ((c["feat_level"][None, :] - c["pred_level"][:, None]).abs() <= 1)
                             & c["proj_valid"][:, None] & c["feat_valid"][None, :]).sum())
            del d2p
            ms, how = device_ms(pfn, "best_two_popc_kernel")
            proj_rows.append({
                "shape": [n, m], "inputs": kind, "valid_pairs": n_valid,
                "window_pairs": passing, "rows_matched": matched, "max_abs_err": 0.0,
                "device_ms": ms, "device_ms_from": how, "call_ms": call_ms(pfn),
                "plain_ms": call_ms(lambda: kernels.hamming_best_two_projection_ref(**c),
                                    reps=5),
                "library_ms": None,
                # a valid pair: 2 sub, 2 mul, 1 add, 1 compare
                **bound(card, 49.0 * n + 45.0 * m + 16.0 * n, popc=8.0 * passing,
                        fp32_instr=5.0 * n_valid, minmax_instr=n_valid)})
    emit("kernel_hamming_best_two_valid", exact=True, popc=valid_rows["popc"],
         mma=valid_rows["mma"])
    emit("kernel_hamming_best_two_projection", exact=True, shapes=proj_rows)
    rows = {f"hamming_best_two_valid_{inner}": dict(valid_rows[inner][0],
                                                    shapes=valid_rows[inner])
            for inner in ("popc", "mma")}
    rows["hamming_best_two_projection"] = dict(proj_rows[0], shapes=proj_rows)
    return rows



def stereo_case(n: int, m: int, gen, dev, kind: str, width: int, height: int) -> dict:
    """Inputs of the stereo match at n x m: left rows near the right
    columns they were made from, about 25% of each invalid. "ties": also
    every 7th column a copy of its neighbour, rows that copy columns, one
    fully masked row and column. "tolerance": each left feature sits
    exactly on the row tolerance of its level, one float32 step beyond it,
    or at disparity exactly 0.3, 128 or one step inside, relative to its
    right feature (integer right positions keep most differences exact)."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    rint = lambda lo, hi, k: torch.randint(lo, hi, (k,), generator=gen, device=dev)
    dL, dR = random_words(n, gen, dev), random_words(m, gen, dev)
    vL, vR = rnd(n) < 0.75, rnd(m) < 0.75
    uvR = torch.round(rnd(m, 2) * torch.tensor([width, height], device=dev))
    levelR = rint(0, 8, m).to(torch.int32)
    src = rint(0, m, n)
    if kind == "ties":
        k = dR[7::7].shape[0]
        dR[7::7] = dR[6:-1:7][:k].clone()
        uvR[7::7] = uvR[6:-1:7][:k].clone()
        vL[min(3, n - 1)] = False
        vR[min(2, m - 1)] = False
    levelL = torch.clamp(levelR[src] + rint(-2, 3, n).to(torch.int32), 0, 7)
    tol = kernels.stereo_row_tolerance(levelL, 2.0)
    if kind == "tolerance":
        step = rint(0, 6, n)
        inf = torch.full_like(tol, float("inf"))
        zero = torch.zeros_like(tol)
        d128 = torch.full_like(tol, 128.0)
        dv = torch.where(step == 0, tol, torch.where(
            step == 1, torch.nextafter(tol, inf), torch.where(step == 2, -tol, zero)))
        disp = torch.where(step == 3, torch.full_like(tol, 0.3), torch.where(
            step == 4, d128, torch.where(step == 5, torch.nextafter(d128, zero),
                                         torch.full_like(tol, 40.0))))
        uvL = uvR[src] + torch.stack([disp, dv], dim=1)
    else:
        uvL = uvR[src] + torch.stack([rnd(n) * 145.0 - 5.0,
                                      torch.randn(n, generator=gen, device=dev) * 3.0], dim=1)
    dL = torch.where((rnd(n) < 0.6)[:, None], dR[src], dL)
    return dict(descL=dL, uvL=uvL.contiguous(), validL=vL, levelL=levelL, tol=tol,
                descR=dR, uvR=uvR, validR=vR, levelR=levelR, max_disparity=128.0)


def check_k2_stereo(cfg, card: dict, gen) -> dict:
    """K2's stereo-masked fused match at the stereo frame's shape (features
    x features): exactness on random, tie and on-the-tolerance cases, then
    times; the bound counts the pairs that pass the float mask."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    dev = torch.device("cuda")
    n = m = cfg.orb.n_features
    rows = []
    for kind in ("random", "ties", "tolerance"):
        c = stereo_case(n, m, gen, dev, kind, cfg.camera.width, cfg.camera.height)
        fn = lambda: kernels.hamming_best_two_stereo(**c)
        got = fn()
        torch.cuda.synchronize()
        require_equal(f"K2 stereo {n}x{m} ({kind})", got,
                      kernels.hamming_best_two_stereo_ref(**c))
        matched = int((got[1] < kernels.BIG).sum())
        if matched == 0 or matched == n:
            raise AssertionError(f"K2 stereo {n}x{m} ({kind}): {matched} of {n} rows "
                                 "have a pair in their window")
        if kind == "ties":
            continue
        # pairs that pass the mask, from the plain arithmetic
        dv = (c["uvL"][:, None, 1] - c["uvR"][None, :, 1]).abs()
        disp = c["uvL"][:, None, 0] - c["uvR"][None, :, 0]
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        passing = float(((dv <= c["tol"][:, None]) & (disp > f32(0.3)) & (disp < f32(128.0))
                         & ((c["levelL"][:, None] - c["levelR"][None, :]).abs() <= 1)
                         & c["validL"][:, None] & c["validR"][None, :]).sum())
        n_valid = float(c["validL"].sum()) * float(c["validR"].sum())
        ms, how = device_ms(fn, "best_two_popc_kernel")
        rows.append({
            "shape": [n, m], "inputs": kind, "valid_pairs": n_valid,
            "window_pairs": passing, "rows_matched": matched, "max_abs_err": 0.0,
            "device_ms": ms, "device_ms_from": how, "call_ms": call_ms(fn),
            "plain_ms": call_ms(lambda: kernels.hamming_best_two_stereo_ref(**c), reps=5),
            "library_ms": None,
            # a valid pair: 2 subtractions and an abs, then 3 compares
            **bound(card, 49.0 * n + 45.0 * m + 16.0 * n, popc=8.0 * passing,
                    fp32_instr=3.0 * n_valid, minmax_instr=3.0 * n_valid)})
    emit("kernel_hamming_best_two_stereo", exact=True, shapes=rows)
    return {"hamming_best_two_stereo": dict(rows[0], shapes=rows)}


def check_matcher_memory(cfg, gen) -> None:
    """The matchers allocate no N x M tensor on the GPU."""
    from multi_orbslam3_tpu_torch.frontend import matcher
    dev = torch.device("cuda")
    n_feat, P = cfg.orb.n_features, cfg.map.max_mappoints
    W, H = cfg.camera.width, cfg.camera.height
    mutual = match_case(P, P, gen, dev, "random", W, H)["valid"]
    c = match_case(P, n_feat, gen, dev, "random", W, H)["projection"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    matcher.match_mutual(*mutual, max_dist=matcher.TH_LOW, ratio=0.95)
    matcher.match_by_projection(c["proj_uv"], c["proj_valid"], c["mp_desc"], c["feat_uv"],
                                c["feat_valid"], c["feat_desc"], c["feat_level"],
                                c["radius"], c["pred_level"])
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    emit("matcher_memory", extra_bytes=extra, nxm_bytes_at_tracking_shape=P * n_feat)
    if extra >= P * n_feat:
        raise AssertionError(f"the matchers allocated {extra} bytes: an N x M tensor")


def phase_kernels(frame: np.ndarray, frame_right: np.ndarray, cfg, card: dict) -> dict:
    """Every kernel against its plain version at the main path's shapes,
    with its times and its bound; {variant name: row}. Each check frees its
    tensors before the next, so the phase's peak is the plain matrix
    version's at 16384x16384."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = check_k1(frame, frame_right, cfg, card, gen)
    rows.update(check_k2_matrix(cfg, card, gen))
    rows.update(check_k2_fused(cfg, card, gen))
    rows.update(check_k2_stereo(cfg, card, gen))
    check_matcher_memory(cfg, gen)
    return rows


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


def phase_sync_free(cfg, slam, seq, stereo_cfg, stereo_slam, stereo_seq) -> None:
    """The fused step (mono and stereo), the mapping chain and the
    place-recognition step launch their work without one device->host
    read: all run under torch's sync debug mode "error"."""
    from multi_orbslam3_tpu_torch.pipeline import local_mapping, loop_closing, tracking
    start_phase()
    img = slam.to_device(seq.images[-1])
    T_cur = slam._upload(slam.T_cur)
    T_vel = slam._upload(slam.T_vel)
    k = int(slam.m.n_kf) - 1
    lc = slam.loop_closer
    il = stereo_slam.to_device(stereo_seq.images[-1])
    ir = stereo_slam.to_device(stereo_seq.images_right[-1])
    Ts_cur = stereo_slam._upload(stereo_slam.T_cur)
    Ts_vel = stereo_slam._upload(stereo_slam.T_vel)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tracking.fused_step_chained(cfg, slam.m, img, T_cur, T_vel)
        tracking.fused_step_stereo_chained(stereo_cfg, stereo_slam.m, il, ir,
                                           Ts_cur, Ts_vel)
        local_mapping.map_keyframe(slam.m, k, slam.K,
                                   **local_mapping.mapping_kwargs(cfg))
        loop_closing._pr_step(lc.db, lc.voc, slam.m, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit("sync_free", fused_step_chained=True, fused_step_stereo_chained=True,
         map_keyframe=True, pr_step=True)


def ate_of(slam, seq, ok_idx, offset: int = 0, with_scale: bool = True) -> tuple:
    """(ATE RMSE, span) of the frames ok_idx of slam.trajectory against
    the sequence's frames ok_idx + offset."""
    from multi_orbslam3_tpu_torch.eval import ate
    est = np.stack([slam.trajectory[i][1] for i in ok_idx])
    if not np.isfinite(est).all():
        raise AssertionError("non-finite poses in the trajectory")
    g = ate.camera_centers(seq.T_cw[np.asarray(ok_idx) + offset])
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    return float(ate.ate_rmse(ate.camera_centers(est), g, with_scale)), span


def check_launches(launches: dict, problems: list, k1_expected=None,
                   both_fused: bool = False, stereo_expected=None) -> None:
    """K1 and a fused K2 kernel must have been launched on the path: K1
    exactly k1_expected times where that is given (once a frame), with
    both_fused the validity and the projection match each at least once,
    and the stereo match exactly stereo_expected times where given."""
    if stereo_expected is not None and \
            launches["hamming_best_two_stereo"] != stereo_expected:
        problems.append(f"K2's stereo match was launched "
                        f"{launches['hamming_best_two_stereo']} times on this path, "
                        f"not {stereo_expected}")
    k1 = launches["fast_score_nms_levels"]
    if k1 <= 0 or (k1_expected is not None and k1 != k1_expected):
        problems.append(f"K1 was launched {k1} times on this path"
                        + (f", not {k1_expected}" if k1_expected is not None else ""))
    valid = launches["hamming_best_two_valid_popc"] + launches["hamming_best_two_valid_mma"]
    proj = launches["hamming_best_two_projection"]
    if valid + proj <= 0 or (both_fused and min(valid, proj) <= 0):
        problems.append(f"K2's fused matches were launched {valid} (validity) and "
                        f"{proj} (projection) times on this path")


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
    check_launches(launches, problems, k1_expected=F, both_fused=True)
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
    from multi_orbslam3_tpu_torch import config as cfgm
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.eval import ate
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


def latency_stats(frame_ms, wall: float) -> dict:
    F = len(frame_ms)
    return {"fps": F / wall, "wall_s": wall,
            "frame_ms_p50": float(np.percentile(frame_ms, 50)),
            "frame_ms_p90": float(np.percentile(frame_ms, 90)),
            "frame_ms_p99": float(np.percentile(frame_ms, 99))}


def run_frames(slam, n_frames: int, step) -> tuple:
    """Drive step(i) for every frame with the launch counts set to 0 just
    before and read just after; (frame ms, wall s, launches)."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    frame_ms = []
    t0 = time.perf_counter()
    for i in range(n_frames):
        tf = time.perf_counter()
        step(i)
        frame_ms.append((time.perf_counter() - tf) * 1e3)
    slam.finish()
    torch.cuda.synchronize()
    return np.asarray(frame_ms), time.perf_counter() - t0, kernels.launch_counts()


def finish_phase(name: str, res: dict, problems: list) -> dict:
    emit(name, **res)
    if problems:
        raise AssertionError(f"{name}: " + "; ".join(problems))
    return res


def phase_stereo(cfg, seq, device: str = "cuda") -> tuple:
    """bench_stereo: StereoSlam with loop closing on through the pipelined
    stereo loop (one timed pass)."""
    from multi_orbslam3_tpu_torch.pipeline import StereoSlam, TrackState
    start_phase()
    F = seq.images.shape[0]
    slam = StereoSlam(cfg, enable_loop_closing=True, device=device)
    frame_ms, wall, launches = run_frames(
        slam, F, lambda i: slam.process_frame_stereo_pipelined(
            seq.images[i], seq.images_right[i], float(seq.timestamps[i])))
    states = [st for _, st in slam.frame_log]
    ok_idx = [i for i, st in enumerate(states) if st == TrackState.OK]
    ate_rmse, span = ate_of(slam, seq, ok_idx, with_scale=False)
    lc = slam.loop_closer
    # what a stereo frame adds to a monocular one, on the final map: one
    # call between events (host included) and the launches of each part
    from multi_orbslam3_tpu_torch.frontend import extractor, stereo
    from multi_orbslam3_tpu_torch.pipeline import tracking
    il, ir = slam.to_device(seq.images[-1]), slam.to_device(seq.images_right[-1])
    T_cur, T_vel = slam._upload(slam.T_cur), slam._upload(slam.T_vel)
    fl, fr = extractor.extract_features_pair(il, ir, cfg)
    bf = cfg.camera.baseline * cfg.camera.fx
    parts = {"extract_features": lambda: extractor.extract_features(il, cfg),
             "extract_features_pair": lambda: extractor.extract_features_pair(il, ir, cfg),
             "stereo_match": lambda: stereo.stereo_match(fl, fr, bf),
             "fused_step_chained": lambda: tracking.fused_step_chained(
                 cfg, slam.m, il, T_cur, T_vel),
             "fused_step_stereo_chained": lambda: tracking.fused_step_stereo_chained(
                 cfg, slam.m, il, ir, T_cur, T_vel)}
    frame_parts = {name: {"call_ms": call_ms(fn, reps=7, warmup=2),
                          "device_launches": device_launches(fn)}
                   for name, fn in parts.items()}
    res = {"frames": F, "frames_ok": len(ok_idx), "state": slam.state.name,
           "kf_inserted": slam.stats["kf_inserted"],
           "mp_created": slam.stats["mp_created"],
           "loops_closed": lc.loops_closed, "ate_rmse_no_scale": ate_rmse, "span": span,
           "ate_over_span": ate_rmse / span, **latency_stats(frame_ms, wall),
           "frame_parts": frame_parts, "launches": launches}
    problems = []
    check_launches(launches, problems, k1_expected=F, both_fused=True, stereo_expected=F)
    if slam.state != TrackState.OK:
        problems.append(f"final state {slam.state.name}")
    if len(states) != F or len(ok_idx) < 70:
        problems.append(f"{len(ok_idx)} of {F} frames OK (< 70), {len(states)} logged")
    if not ate_rmse <= 0.02 * span:
        problems.append(f"ATE without scale alignment {ate_rmse:.4f} m > 0.02 x span "
                        f"{span:.3f} m")
    return finish_phase("stereo", res, problems), slam


def phase_rgbd(cfg, seq, n_frames: int = 40, device: str = "cuda") -> dict:
    """The stereo sequence's depth images through RGBDSlam."""
    from multi_orbslam3_tpu_torch.pipeline import RGBDSlam, TrackState
    start_phase()
    slam = RGBDSlam(cfg.replace(sensor="rgbd"), enable_loop_closing=True, device=device)
    frame_ms, wall, launches = run_frames(
        slam, n_frames, lambda i: slam.process_frame_rgbd(
            seq.images[i], seq.depths[i], float(seq.timestamps[i])))
    states = [st for _, st in slam.frame_log]
    ok_idx = [i for i, st in enumerate(states) if st == TrackState.OK]
    ate_rmse, span = ate_of(slam, seq, ok_idx, with_scale=False)
    res = {"frames": n_frames, "frames_ok": len(ok_idx), "state": slam.state.name,
           "kf_inserted": slam.stats["kf_inserted"],
           "mp_created": slam.stats["mp_created"], "ate_rmse_no_scale": ate_rmse,
           "span": span, **latency_stats(frame_ms, wall), "launches": launches}
    problems = []
    check_launches(launches, problems, k1_expected=n_frames, stereo_expected=0)
    if slam.state != TrackState.OK:
        problems.append(f"final state {slam.state.name}")
    if len(ok_idx) < 35:
        problems.append(f"only {len(ok_idx)} of {n_frames} frames OK (< 35)")
    if not ate_rmse <= 0.08 * span:
        problems.append(f"ATE {ate_rmse:.4f} m > 0.08 x span {span:.3f} m")
    return finish_phase("rgbd", res, problems)


def imu_dt(seq, i: int, rate: float) -> np.ndarray:
    dt = np.diff(seq.imu_t[i], prepend=seq.imu_t[i][0] - 1.0 / rate)
    return np.where(seq.imu_t[i] > 0, np.maximum(dt, 0.0), 0.0)


def inertial_timers() -> tuple:
    from multi_orbslam3_tpu_torch.imu import preintegration
    from multi_orbslam3_tpu_torch.opt import inertial_ba, inertial_init, vi_pose_opt
    return (StageTimes(preintegration, ["preintegrate"]),
            StageTimes(vi_pose_opt, ["pose_inertial_optimization"]),
            StageTimes(inertial_ba, ["inertial_bundle_adjust"]),
            StageTimes(inertial_init, ["inertial_init"]))


def inertial_stage_ms(timers, n_frames: int) -> dict:
    """{stage: calls, median ms of a call, ms per frame over the run}."""
    out = {}
    for t in timers:
        for name, st in t.close().items():
            out[name] = {"calls": st["calls"], "ms_median": st["ms_median"],
                         "ms_per_frame": float(np.sum(st["ms"])) / n_frames}
    return out


@reproducible()
def phase_mono_inertial(device: str = "cuda") -> dict:
    """bench_mono_inertial: MonoInertialSlam with EuRoC's camera-IMU
    extrinsics, one timed pass, scored on the final map's keyframes after
    the init frame."""
    from multi_orbslam3_tpu_torch import config as cfgm
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.eval import ate
    from multi_orbslam3_tpu_torch.pipeline import MonoInertialSlam, TrackState
    start_phase()
    c = euroc_scale_config().replace(imu=cfgm.IMUConfig(T_bc=EUROC_T_BC))
    F = 90
    seq = synthetic.make_sequence(c, n_frames=F, n_points=1200, seed=7,
                                  trajectory="forward", imu=True, lateral=0.8,
                                  sway_freq=0.15)
    slam = MonoInertialSlam(c, enable_loop_closing=True, device=device)
    timers = inertial_timers()
    frame_ms, wall, launches = run_frames(
        slam, F, lambda i: slam.process_frame_imu(
            seq.images[i], float(seq.timestamps[i]), seq.imu_acc[i], seq.imu_gyro[i],
            imu_dt(seq, i, c.imu.rate_hz)))
    stages = inertial_stage_ms(timers, F)
    # the launches of one frame's preintegration (a full window of samples)
    from multi_orbslam3_tpu_torch.imu import preintegration
    S = c.imu.max_samples_per_frame
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    acc, gyro = (torch.randn((S, 3), generator=gen, device=device) * k for k in (1.0, 0.1))
    dt = torch.full((S,), 1.0 / c.imu.rate_hz, device=device)
    zero3 = torch.zeros(3, device=device)
    stages["preintegrate"]["device_launches"] = device_launches(
        lambda: preintegration.preintegrate(acc, gyro, dt, zero3, zero3, slam.calib))
    states = [st for _, st in slam.frame_log]
    init_f = slam.stats.get("imu_init_frame")
    ts0 = float(seq.timestamps[0])
    frames, poses = [], []
    for t, T in slam.keyframe_trajectory():
        fr = int(round((t - ts0) * c.camera.fps))
        if init_f is not None and init_f <= fr < F:
            frames.append(fr)
            poses.append(T)
    ate_rmse = span = None
    if len(frames) >= 2:
        g = ate.camera_centers(seq.T_cw[frames])
        span = float(np.linalg.norm(g.max(0) - g.min(0)))
        ate_rmse = float(ate.ate_rmse(ate.camera_centers(np.stack(poses)), g))
    scale = slam.stats.get("imu_init_scale")
    res = {"frames": F, "frames_ok": sum(st == TrackState.OK for st in states),
           "state": slam.state.name, "imu_initialized": bool(slam.imu_initialized),
           "inertial_ready": bool(slam.inertial_ready), "imu_init_frame": init_f,
           "imu_init_scale": scale, "kf_inserted": slam.stats["kf_inserted"],
           "kf_evaluated": len(frames), "ate_rmse": ate_rmse, "span": span,
           **latency_stats(frame_ms, wall), "stages": stages, "launches": launches}
    problems = []
    check_launches(launches, problems, k1_expected=F, stereo_expected=0)
    if not slam.imu_initialized:
        problems.append("the IMU was never initialized")
    elif not 0.05 < scale < 50.0:
        problems.append(f"init scale {scale}")
    if len(frames) < 8:
        problems.append(f"only {len(frames)} keyframes after the init frame (< 8)")
    elif not ate_rmse <= 0.1 * span:
        problems.append(f"keyframe ATE {ate_rmse:.4f} m > 0.1 x span {span:.3f} m")
    return finish_phase("mono_inertial", res, problems)


@reproducible()
def phase_stereo_inertial(device: str = "cuda") -> dict:
    """tests/test_stereo_inertial.py's drill at bench width (a tilted,
    offset T_bc; 50 frames), then RGBDInertialSlam on 20 frames of it."""
    from multi_orbslam3_tpu_torch import config as cfgm
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.geometry import so3
    from multi_orbslam3_tpu_torch.pipeline import (RGBDInertialSlam, StereoInertialSlam,
                                                   TrackState)
    start_phase()
    T_bc = np.eye(4)
    T_bc[:3, :3] = so3.exp(torch.tensor([0.3, -0.2, 0.25])).numpy()
    T_bc[:3, 3] = [0.05, -0.03, 0.02]
    c = euroc_scale_config(baseline=0.11).replace(
        sensor="imu_stereo", imu=cfgm.IMUConfig(T_bc=tuple(float(x) for x in T_bc.reshape(-1))))
    F = 50
    seq = synthetic.make_sequence(c, n_frames=F, n_points=1200, seed=11,
                                  trajectory="forward", imu=True, lateral=0.6,
                                  sway_freq=0.15)
    slam = StereoInertialSlam(c, enable_loop_closing=True, device=device)
    timers = inertial_timers()
    frame_ms, wall, launches = run_frames(
        slam, F, lambda i: slam.process_frame_stereo_imu(
            seq.images[i], seq.images_right[i], float(seq.timestamps[i]),
            seq.imu_acc[i], seq.imu_gyro[i], imu_dt(seq, i, c.imu.rate_hz)))
    stages = inertial_stage_ms(timers, F)
    states = [st for _, st in slam.frame_log]
    ok_idx = [i for i, st in enumerate(states) if st == TrackState.OK]
    ate_rmse, span = ate_of(slam, seq, list(range(len(states))), with_scale=False)
    scale = slam.stats.get("imu_init_scale")
    # RGB-D-inertial on the same sequence's depth images
    n_rgbd = 20
    rgbd = RGBDInertialSlam(c.replace(sensor="imu_rgbd"), enable_loop_closing=True,
                            device=device)
    _, wall_rgbd, launches_rgbd = run_frames(
        rgbd, n_rgbd, lambda i: rgbd.process_frame_rgbd_imu(
            seq.images[i], seq.depths[i], float(seq.timestamps[i]),
            seq.imu_acc[i], seq.imu_gyro[i], imu_dt(seq, i, c.imu.rate_hz)))
    rgbd_ok = sum(st == TrackState.OK for _, st in rgbd.frame_log)
    res = {"frames": F, "frames_ok": len(ok_idx), "state": slam.state.name,
           "imu_initialized": bool(slam.imu_initialized),
           "imu_init_frame": slam.stats.get("imu_init_frame"), "imu_init_scale": scale,
           "kf_inserted": slam.stats["kf_inserted"], "ate_rmse_no_scale": ate_rmse,
           "span": span, "v_norm": float(np.linalg.norm(slam.v_cur)),
           **latency_stats(frame_ms, wall), "stages": stages,
           "rgbd_inertial": {"frames": n_rgbd, "frames_ok": rgbd_ok,
                             "state": rgbd.state.name, "wall_s": wall_rgbd,
                             "imu_initialized": bool(rgbd.imu_initialized),
                             "launches": launches_rgbd},
           "launches": {k: v + launches_rgbd[k] for k, v in launches.items()}}
    problems = []
    check_launches(launches, problems, k1_expected=F, stereo_expected=F)
    check_launches(launches_rgbd, problems, k1_expected=n_rgbd, stereo_expected=0)
    if not slam.imu_initialized:
        problems.append("the IMU was never initialized")
    elif not abs(scale - 1.0) < 1e-5:
        problems.append(f"the fixed-scale init re-scaled the map: {scale}")
    if not ate_rmse <= 0.1 * max(span, 1.0):
        problems.append(f"ATE {ate_rmse:.4f} m > 0.1 x max(span {span:.3f}, 1)")
    if not np.isfinite(slam.v_cur).all():
        problems.append("non-finite velocity")
    if rgbd.state != TrackState.OK:
        problems.append(f"RGBDInertialSlam ended {rgbd.state.name}")
    return finish_phase("stereo_inertial", res, problems)


def main() -> int:
    card = phase_device()
    phase_build()
    from multi_orbslam3_tpu_torch.dataio import synthetic
    cfg = euroc_scale_config()
    stereo_cfg = euroc_scale_config(baseline=0.11).replace(sensor="stereo")
    t0 = time.perf_counter()
    seq = synthetic.make_sequence(cfg, n_frames=120, n_points=1500, seed=5,
                                  trajectory="forward")
    stereo_seq = synthetic.make_sequence(stereo_cfg, n_frames=80, n_points=1200, seed=9,
                                         trajectory="forward")
    emit("sequence", frames=int(seq.images.shape[0]),
         stereo_frames=int(stereo_seq.images.shape[0]),
         shape=list(seq.images.shape[1:]),
         seconds=round(time.perf_counter() - t0, 3))
    as_u8 = lambda im: np.clip(np.round(im), 0, 255).astype(np.uint8)
    start_phase()
    seconds = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = round(time.perf_counter() - t, 3)
        return out

    rows = timed("kernels", phase_kernels, as_u8(stereo_seq.images[0]),
                 as_u8(stereo_seq.images_right[0]), cfg, card)
    res, slam = timed("slice", phase_slice, cfg, seq, loop_closing=True)
    res_off, _ = timed("slice_lc_off", phase_slice, cfg, seq, loop_closing=False)
    res_reloc = timed("relocalize", phase_relocalize, cfg, seq, slam)
    res_atlas = timed("atlas_loop", phase_atlas_loop)
    res_stereo, stereo_slam = timed("stereo", phase_stereo, stereo_cfg, stereo_seq)
    res_rgbd = timed("rgbd", phase_rgbd, stereo_cfg, stereo_seq)
    res_mi = timed("mono_inertial", phase_mono_inertial)
    res_si = timed("stereo_inertial", phase_stereo_inertial)
    timed("sync_free", phase_sync_free, cfg, slam, seq, stereo_cfg, stereo_slam, stereo_seq)
    emit("total", seconds_by_phase=seconds,
         total_s=round(time.perf_counter() - T_START, 3))
    paths = (res, res_off, res_reloc, res_atlas, res_stereo, res_rgbd, res_mi, res_si)
    entries = []
    for name, k in KERNELS.items():
        variants = []
        for vname, source in k["variants"].items():
            r = rows[vname]
            variants.append({
                "name": vname, "route": "cuda", "source": source, "replaces": k["replaces"],
                "launches": sum(p["launches"][vname] for p in paths),
                "max_abs_err": r["max_abs_err"], "shape": r["shape"],
                "ms": r["device_ms"], "device_ms": r["device_ms"], "call_ms": r["call_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "limit": r["limit"], "library_ms": None})
        head = next(v for v in variants if v["name"] == k["headline"])
        entries.append({**head, "name": name, "source": k["source"],
                        "measured_as": k["headline"],
                        "launches": sum(v["launches"] for v in variants),
                        "variants": variants})
    print(card["smi"], flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
