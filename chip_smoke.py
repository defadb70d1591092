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
     same three shapes, and the projection-masked one at 16384x1024 and
     1024x1024, on random descriptors with about 25% of rows and columns
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
7. sync_free: one fused step, one mapping chain and one place-recognition
   step on the final map run under torch's sync debug mode "error": none
   reads the device back.

Kernel launch counts are reset just before each driven path (the timed
passes of 3 and 4, and 5 and 6) and read just after it; each fails unless
K1 and a K2 kernel were launched. The last three lines of stdout are the
card's nvidia-smi name/power-limit line, a JSON summary of the kernels
(one entry for each TPU kernel, its variants beneath it, launches summed
over those paths), and {"ok": true, "device": ...}. The script imports
torch, numpy, the standard library and the port: nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import collections
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
            "hamming_best_two_projection": "multi_orbslam3_tpu_torch/csrc/hamming.cu"}},
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


def euroc_scale_config():
    """The bench_mono configuration (eval/benchmarks.py::_euroc_scale_config):
    EuRoC-sized pinhole camera with the default capacities (1024 ORB
    features over 8 levels, 512 keyframes, 16384 landmarks)."""
    from multi_orbslam3_tpu_torch import config as cfg
    cam = cfg.CameraConfig(width=752, height=480, fx=458.654, fy=457.296,
                           cx=376.0, cy=240.0)
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


def check_k1(frame: np.ndarray, cfg, card: dict, gen) -> dict:
    """K1 level by level, then as one launch for the pyramid."""
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
    emit("kernel_fast_score_nms", exact=True, per_level=per_level,
         per_level_device_ms_sum=sum(r["device_ms"] for r in per_level), all_levels=k1)
    return {"fast_score_nms_levels": dict(k1["frame"], on_noise=k1["noise"])}



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


def phase_kernels(frame: np.ndarray, cfg, card: dict) -> dict:
    """Every kernel against its plain version at the main path's shapes,
    with its times and its bound; {variant name: row}. Each check frees its
    tensors before the next, so the phase's peak is the plain matrix
    version's at 16384x16384."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = check_k1(frame, cfg, card, gen)
    rows.update(check_k2_matrix(cfg, card, gen))
    rows.update(check_k2_fused(cfg, card, gen))
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
    from multi_orbslam3_tpu_torch.eval import ate
    est = np.stack([slam.trajectory[i][1] for i in ok_idx])
    if not np.isfinite(est).all():
        raise AssertionError("non-finite poses in the trajectory")
    g = ate.camera_centers(seq.T_cw[np.asarray(ok_idx) + offset])
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    return float(ate.ate_rmse(ate.camera_centers(est), g, with_scale)), span


def check_launches(launches: dict, problems: list, k1_expected=None,
                   both_fused: bool = False) -> None:
    """K1 and a fused K2 kernel must have been launched on the path: K1
    exactly k1_expected times where that is given (once a frame), and with
    both_fused the validity and the projection match each at least once."""
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


def main() -> int:
    card = phase_device()
    phase_build()
    from multi_orbslam3_tpu_torch.dataio import synthetic
    cfg = euroc_scale_config()
    t0 = time.perf_counter()
    seq = synthetic.make_sequence(cfg, n_frames=120, n_points=1500, seed=5,
                                  trajectory="forward")
    emit("sequence", frames=int(seq.images.shape[0]),
         shape=list(seq.images.shape[1:]),
         seconds=round(time.perf_counter() - t0, 3))
    frame0 = np.clip(np.round(seq.images[0]), 0, 255).astype(np.uint8)
    start_phase()
    rows = phase_kernels(frame0, cfg, card)
    res, slam = phase_slice(cfg, seq, loop_closing=True)
    res_off, _ = phase_slice(cfg, seq, loop_closing=False)
    res_reloc = phase_relocalize(cfg, seq, slam)
    res_atlas = phase_atlas_loop()
    phase_sync_free(cfg, slam, seq)
    paths = (res, res_off, res_reloc, res_atlas)
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
