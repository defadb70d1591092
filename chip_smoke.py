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
   - K2 as a matrix (the tensor-core writer) at 16384x1024, 1024x1024 and
     16384x16384, timed in turns with torch._int_mm, cuBLASLt's int8
     product, on the descriptors unpacked once to +-1 int8 (which gives
     256 - 2 x the distance; the unpack is library_prep_ms): the library
     yardstick, which the port never calls;
   - K2's fused matches, which write no N x M: the validity-masked one
     (the compacted tensor-core search) at the same three shapes, the
     projection-masked one (the grid-indexed window search) at 16384x1024
     and 1024x1024, on random descriptors with about 25% of rows and
     columns invalid and on a tie case (every 7th descriptor duplicated,
     one fully masked row and column); both are also timed with every row
     and column valid and the validity match, at 16384x16384, with about
     4% valid (the loop closer's masks); then the edge cases, bit for bit
     (check_k2_edges: pairs exactly on the radius at 16-px cell borders,
     features outside the image and at NaN or inf, an infinite radius, a
     level slack of every level, nothing or one thing valid, shapes off
     the tiles, 4,608 columns and past one launch, ties across the
     validity search's column splits); each matcher's device launches a
     call, counted from a CUDA graph of one call, are printed and may not
     exceed the parent design's (PARENT_DEVICE_LAUNCHES);
     the matchers are checked to allocate no N x M tensor;
   - K2's stereo match (the row-band search) at 1024x1024 on random and
     tie cases, on pairs exactly on the row tolerance and the disparity
     limits, on ties that reach a row out of column order and on rows
     whose band is empty or lies at the image's first or last row, at
     4096x4096 (one launch's capacity, a KITTI-size 1241x376 frame) and
     past it in column chunks (4608x4608 at 752x480, 8192x8192 at
     1241x376); K1 also past one launch's 16 levels (the 18 and 24 levels
     of a stereo pair's 9- and 12-level pyramids, one launch a group);
   - the motion-only pose optimisation (csrc/pose_opt.cu, one launch a
     call; no TPU kernel) at the tracking call's shape (1,280 stereo rows,
     2 x 7) and at 2,000 mono rows (4 x 10): bit for bit its CPU model run
     on the card, against its plain version (opt/pose_opt.py) the camera
     centre within 1e-5 m and the inliers equal but for rows within 1e-4
     of their threshold; its bound is the latency of its dependent
     iterations, printed beside the bytes it reads (check_pose_opt).
   Each row has call_ms (median time of one call between CUDA events,
   host launch latency included), device_ms (the kernel's own duration:
   torch.profiler's device self time over 50 launches, or 50 launches
   replayed from a CUDA graph if the profiler shows none), plain_ms, and
   bound_ms: the least time the card could take, from this run's inputs
   (bytes over 3.35 TB/s; Hamming distances on the tensor cores, 2 x 256
   int8 operations a pair at 1,979 TOP/s, for the pairs these inputs
   need; float add/multiply over 128 and min/max/compare over 64 a clock
   an SM), with the limit that binds; the projection match's counts its
   inputs, outputs and the pairs inside the windows, not the float tests
   of the pairs a search discards; K2's rows also carry popc_bound_ms,
   the same bound with the distances counted by __popc (16 a clock an SM,
   8 a pair). library_ms is torch._int_mm's device time for the matrix
   and null for the rest: no PyTorch call computes a fused best-two match
   or a FAST score;
3. slice: bench_mono as the JAX package scores it: the port's MonoSlam
   with loop closing on (the default) and the bundled k=10 L=5 vocabulary
   on the bench sequence (752x480, 120 frames, 1500 landmarks, seed 5,
   forward), driven like eval/benchmarks.py::_drive_mono (warm-up pass,
   then a timed pass on a fresh system). The warm-up pass keeps the
   inputs of the 60th coarse tracking call and of the first keyframe-pair
   triangulation after it; right after the phase both fused matchers are
   held bit for bit and timed on them (kernels_captured,
   check_k2_captured). Fails unless K1 was launched once
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
7b. stereo_wide: the first 20 frames of the same sequence at 4,608 ORB
   features over 9 levels (more right features than one launch of the
   stereo match takes, 4,096, and for the pair 18 levels, more than one K1
   launch takes, 16): >= 18 frames OK, ATE without scale alignment <= 0.02
   x span (the JAX package's run of the cell on a CPU,
   profiling/jax_stereo_wide_cpu.py, printed beside), K1 and the stereo
   match launched twice a frame; K1 and the stereo match on frame 0's own
   inputs against their plain versions;
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
11. collab: bench_collab (eval/benchmarks.py:186-287) on the port: two
   CollabClients and a CollabServer over InProcessTransport, synthetic_mono
   (640x480, 1024 features; the arena holds 1024 keyframes and 32768
   landmarks), 150 frames an agent of a circular orbit (seed 31), GBA on
   events and periodic, drain_gba at the end, one timed pass. Fails unless
   a merge happened, a GBA was adopted, every agent has >= 8 valid server
   keyframes, >= 120 of 150 frames OK and a server-arena keyframe ATE
   < 0.02 x max(span, 1) (tests/test_collab_bench_scale.py's gate), K1 ran
   once a client frame and the server itself launched the fused validity
   match (its cascade) and the fused projection match (its arena fuse).
   Run under torch's deterministic algorithms with the server's
   `deterministic` flag (one GBA step a cycle, adoption on a fixed
   cycle): free-running, about one run in six ends with one agent's
   keyframes metres off, as the JAX package's own runs do on three of
   seeds 31-34 (see `reproducible`; profiling/jax_collab_cpu.py).
   Prints merges, loops, GBA runs/rejections/aborts, culls, bytes up and
   down, total_fps_wall, the server comm_cycle's ms (p50/p90/p99, CUDA
   events), one GN step with 40 CG iterations on the final arena, the
   cascade's and correct_loop's ms, peak memory, codec_native and the
   merge record's summary (`merge_record`: each accepted merge's RANSAC
   inliers, n_proj and Sim3 error against ground truth, agent 1's median
   own-landmark inliers over the 20 frames before and after the first
   merge; profiling/collab_merge_record.py);
12. collab_inertial (under `reproducible`, with the server's
   `deterministic` flag): tests/test_collab_inertial.py's drill at
   synthetic_mono's full width (640x480, 1024 features, 8 levels, 512
   keyframes and 16384 landmarks an agent, the bundled vocabulary; the
   drill's event gates): a mono-inertial CollabClient and a mono one, 90
   frames each of a forward trajectory with sway (seed 31), GBA on events,
   drain_gba at the end. The JAX test's gates: IMU initialized and nothing
   sent before, the server knows the agent is inertial, >= 1 merge,
   corrections applied on both clients, VI ATE after init and the mono
   agent's post-merge ATE < 0.12 x max(span, 1), mean gravity tilt < 3
   degrees and its rise < 1.5, >= 1 joint inertial solve; K1 once a client
   frame. Prints merges, GBA runs, vi_solves, vi_pts_truncated (joint
   solves whose landmark set hit the 4096 cap), bytes, fps, the server
   cycle's ms and one run_full_inertial_ba on the final arena (CUDA
   events). The mean-tilt gate is printed beside the JAX package's value,
   not enforced: the JAX package fails it at this width at every length
   from 88 to 170 frames (6.51 degrees at 90;
   profiling/jax_collab_inertial_curve.py), because its two-view bootstrap
   takes frames 0 and 2 with the translation about 40 degrees off and the
   first inertial initialisation on those keyframes leaves gravity 4.5-6.8
   degrees off (ROADMAP queue C: at this width the gate stays printed, not
   enforced). A failed gate of this phase is raised at the end, after the
   later phases (which use its server) have run and printed;
13. full_inertial_gba: tests/test_full_inertial_gba.py's drifted 56-keyframe
   arena from the port's modules (eval/inertial_drill.py): the joint solve
   must leave < 0.6 x the drifted ATE and < 0.8 x the windowed pass's;
14. sync_free: one fused step (mono and stereo), one mapping chain, one
   place-recognition step, one global-BA step on the collab phase's final
   arena and one joint visual-inertial window solve on the collab_inertial
   arena run under torch's sync debug mode "error": none reads the device
   back;
15. sharded_gba: on the collab phase's final arena, the global BA sharded
   over four shards of the card and CollabServer.run_global_ba(force_shard=
   True) over [cuda:0] against the unsharded solve: poses and points
   within 1e-3 relative, chi2 within 1e-4; ms per GN step for 1 and 4
   shards; then dryrun.dryrun_multichip over four shards (agent-parallel
   pose optimisation, the sharded GBA on a 256-keyframe arena, chi2 may
   not rise more than 1%);
16. harness: the port's benchmark module and apps (phase_harness):
   bench_mini_asl (the EuRoC-layout ingest drill, 80 frames at 752x480
   written as an ASL tree and read back: >= 70 OK, ATE <= 0.02 x span, the
   JAX package's 78/80 and 0.0216 m printed beside),
   bench_vocab_selectivity at its defaults (top-1 hits within one query
   of 270 and margins within 1% of the JAX package's), bench_gba_large
   (1,024 keyframes, 32,768 landmarks: finite, both solves adopted; PCG
   iterations/s and peak MiB), bench_kernels (K1 and K2's matrix equal to
   their plain versions; K2's matrix has no other caller on a driven
   path), then apps.run_slam (60 frames) and apps.run_server with two
   apps.run_client processes over localhost TCP at full width, gated like
   tests/test_multiprocess.py (merges printed). A failed gate is raised at
   the end, after the kernels line;
17. profiling: the port's profilers (multi_orbslam3_tpu_torch/profiling/)
   at the JAX scripts' shapes (phase_profiling): profile_stages,
   profile_scatter, profile_covis, profile_mono with a torch.profiler
   trace of frames 60-79 of the mono loop (busy share, top device ops,
   launches a frame) and profile_ab_u8, one JSON line each. Gated on the
   formulations' agreement, K1 and a fused K2 launched in the mono timed
   pass and a busy share in (0, 1]; a failed gate is raised at the end,
   after the kernels line.

The kernels phase also holds K2's fused matches at the collaborative
arena's shapes: the validity match at 32768 x 32768 (about 4% and about
75% valid) and the projection match at 32768 x 1024.

Kernel launch counts are reset just before each driven path (the timed
passes of 3 and 4, 5 to 12, the benchmarks of 16 and each profiler of 17; the apps of 16
run in processes of their own, whose launches are not counted) and read just after it; each fails unless
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
import os
import subprocess
import sys
import time
import traceback

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
            "hamming_matrix": "multi_orbslam3_tpu_torch/csrc/hamming_mma.cu",
            "hamming_best_two_valid": "multi_orbslam3_tpu_torch/csrc/hamming_mma.cu",
            "hamming_best_two_projection": "multi_orbslam3_tpu_torch/csrc/hamming.cu",
            "hamming_best_two_stereo": "multi_orbslam3_tpu_torch/csrc/stereo_band.cu"}},
}

# Peak rates the bounds are taken against (one H100 SXM): HBM bytes/s and
# the dense int8 tensor rate from the data sheet (the rate at which +-1
# int8 vectors give Hamming distances; no 1-bit peak is published); __popc
# results, float32 add/multiply and float32 min/max or compare
# instructions per clock per SM from the arithmetic-throughput table of
# NVIDIA's CUDA documentation for compute capability 9.0 (the data sheet's
# 67 TFLOP/s is 128 FMA a clock an SM, an FMA counted as 2).
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
    gates are then checked on a result that repeats. The collab phase runs
    under it too, with the server's `deterministic` flag, which takes the
    GBA's step and adoption timing off the host's speed. Free-running,
    four of 24 runs on an H100 (seeds 31-34) ended with an agent's arena
    keyframes 0.2-2.6 m off after alignment: after the merge, one client's
    own-landmark inliers thinned to 20-50 and its tracking drifted metres
    off while it reported every frame OK. The JAX package's runs fail the
    same way, on three of those four seeds (profiling/jax_collab_cpu.py).
    Deterministic runs repeat one result, which passes on seed 31. (The port works on one
    stream, so cuBLAS keeps one order without a fixed workspace: the result
    is the same digits with and without CUBLAS_WORKSPACE_CONFIG.)"""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


# K2's inputs captured in the slice's warm-up pass, for check_k2_captured
CAPTURED = {}
# frames a K2 call site is not read from: the wrappers, the matcher, K2Capture
_K2_SKIP = ("frontend/kernels.py", "frontend/matcher.py", "chip_smoke.py")


def k2_call_site(depth: int = 2) -> tuple:
    """(file:line, function, frame) of the first frame outside the kernels
    module, the matcher and this script."""
    f = sys._getframe(depth)
    while f is not None and any(f.f_code.co_filename.endswith(s) for s in _K2_SKIP):
        f = f.f_back
    if f is None:
        return "?", "?", None
    rel = f.f_code.co_filename.split("multi_orbslam3_tpu_torch/")[-1]
    return f"{rel}:{f.f_lineno}", f.f_code.co_name, f


class K2Capture:
    """Wraps kernels.hamming_best_two_projection and
    kernels.hamming_best_two_valid (the matcher calls them through the
    module) and keeps, in `cases`, clones of the arguments of the
    `track_call`-th coarse tracking call (tracking's _match_and_invert with
    level_slack 2) and of the first keyframe-pair triangulation
    (local_mapping.triangulate_pair) after it with a valid row and column.
    Every call is also passed to `seen` (profiling/k2_matcher_shapes.py
    records there). The wrapped functions' results are returned unchanged."""

    NAMES = ("hamming_best_two_projection", "hamming_best_two_valid")

    def __init__(self, capture: bool = True, track_call: int = 60):
        self.capture, self.track_call = capture, track_call
        self.cases = {}
        self._coarse = 0
        self._orig = {}

    def __enter__(self):
        import inspect
        from multi_orbslam3_tpu_torch.frontend import kernels
        for name in self.NAMES:
            fn = getattr(kernels, name)
            self._orig[name] = fn
            setattr(kernels, name, self._wrap(name, fn, inspect.signature(fn)))
        return self

    def __exit__(self, *exc):
        from multi_orbslam3_tpu_torch.frontend import kernels
        for name, fn in self._orig.items():
            setattr(kernels, name, fn)
        return False

    def seen(self, name: str, site: str, func: str, args: dict) -> None:
        """One call of `name` from `site` (in `func`) with `args`."""

    def _wrap(self, name, fn, sig):
        def wrapped(*args, **kw):
            site, func, frame = k2_call_site()
            c = sig.bind(*args, **kw).arguments
            if self.capture:
                self._maybe_capture(name, func, frame, c)
            self.seen(name, site, func, c)
            return fn(*args, **kw)
        return wrapped

    def _maybe_capture(self, name, func, frame, c):
        clone = lambda c: {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
                           for k, v in c.items()}
        if name == "hamming_best_two_projection" and func == "_match_and_invert" \
                and frame.f_locals.get("level_slack") == 2:
            self._coarse += 1
            if self._coarse == self.track_call and "tracking_coarse" not in self.cases:
                self.cases["tracking_coarse"] = clone(c)
        if name == "hamming_best_two_valid" and func == "triangulate_pair" \
                and "tracking_coarse" in self.cases and "triangulation" not in self.cases \
                and int(c["valid1"].sum()) > 0 and int(c["valid2"].sum()) > 0:
            self.cases["triangulation"] = clone(c)


def profiling_module(name: str):
    """Import one of the repo's profiling/ scripts as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "profiling")
    if path not in sys.path:
        sys.path.insert(0, path)
    import importlib
    return importlib.import_module(name)


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


def device_ms(fn, kernel_name: str, launches: int = 50, per_call: int = 1) -> tuple:
    """(ms, how): the mean device time of one call of fn in the kernel
    whose name contains kernel_name (per_call launches of it a call), over
    `launches` calls. From torch.profiler's device self time of that
    kernel; if the profiler shows no device time, from a CUDA graph of the
    calls replayed between two events (which also counts the wrapper's
    other small kernels and the gaps between launches)."""
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
    if count >= launches * per_call:
        return total_us / (count / per_call) / 1e3, "profiler"
    return graph_ms(fn, launches), "cuda_graph"


def graph_ms(fn, launches: int) -> float:
    """The mean time of one call of fn, from a CUDA graph of `launches`
    calls replayed between two events."""
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
    return start.elapsed_time(end) / launches


def device_launches(fn) -> int:
    """Kernels, memcpys and memsets that one call of fn issues, read from
    torch.profiler's device events (profiling/common.py: each counted once,
    not also through the host op that launched it)."""
    from multi_orbslam3_tpu_torch.profiling import common
    return common.launches(fn, torch.device("cuda"))


def bound(card: dict, nbytes: float, hamming_pairs: float = 0.0, fp32_instr: float = 0.0,
          minmax_instr: float = 0.0) -> dict:
    """The least time the card could take: the largest of the bytes over
    the HBM rate, the Hamming distances of `hamming_pairs` pairs on the
    tensor cores (2 x 256 int8 operations a pair: +-1 vectors give
    256 - 2 x the distance) and the float operations over their peak rate.
    Where there are Hamming pairs, popc_bound_ms is the same bound with
    the distances counted by __popc instead (8 a pair at 16 a clock an SM),
    the instruction the fused matches count bits with."""
    clk = card["sm_count"] * card["max_sm_clock_hz"]
    limits = {"bytes": nbytes / HBM_BYTES_PER_S,
              "products at the int8 tensor rate":
                  2.0 * 256.0 * hamming_pairs / INT8_TENSOR_OPS_PER_S,
              "float ops": (fp32_instr / FP32_INSTR_PER_CLK_SM
                            + minmax_instr / MINMAX_PER_CLK_SM) / clk}
    limit = max(limits, key=limits.get)
    out = {"bound_ms": limits[limit] * 1e3,
           "bound_by": "bytes" if limit == "bytes" else "operations",
           "limit": limit}
    if hamming_pairs:
        popc = dict(limits, **{"products at the int8 tensor rate":
                               8.0 * hamming_pairs / (POPC_PER_CLK_SM * clk)})
        out["popc_bound_ms"] = max(popc.values()) * 1e3
    return out


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
    # more levels than one launch takes: the pyramids of both images at 9
    # levels (18, stereo_wide's frame) and at 12 levels (24), one launch a
    # group of kernels.even_groups
    grouped = []
    for n_lv in (9, 12):
        both = [im.contiguous() for img in (frame, frame_right)
                for im in pyramid.build_pyramid(torch.from_numpy(img).to(dev).float(),
                                                n_lv, o.scale_factor)]
        per_call = len(kernels.even_groups(len(both), kernels.MAX_LEVELS))
        before = kernels.launch_counts()["fast_score_nms_levels"]
        got = kernels.fast_score_nms_levels(both, thr)
        torch.cuda.synchronize()
        if kernels.launch_counts()["fast_score_nms_levels"] - before != per_call:
            raise AssertionError(f"K1 at {len(both)} levels: not {per_call} launches")
        require_equal(f"K1 {len(both)} levels", got,
                      kernels.fast_score_nms_levels_ref(both, thr))
        interior, passing = compass_pass_count(both, thr)
        ms, how = device_ms(lambda: kernels.fast_score_nms_levels(both, thr),
                            "fast_score_nms_levels_kernel", per_call=per_call)
        grouped.append({
            "shape": [list(im.shape) for im in both], "levels": len(both),
            "launches_per_call": per_call, "inputs": "rendered stereo pair",
            "max_abs_err": 0.0, "device_ms": ms, "device_ms_from": how,
            "call_ms": call_ms(lambda: kernels.fast_score_nms_levels(both, thr)),
            "plain_ms": call_ms(lambda: kernels.fast_score_nms_levels_ref(both, thr), reps=5),
            "library_ms": None,
            **bound(card, 8.0 * sum(im.numel() for im in both), fp32_instr=16.0 * interior,
                    minmax_instr=8.0 * interior + 158.0 * passing)})
    emit("kernel_fast_score_nms", exact=True, per_level=per_level,
         per_level_device_ms_sum=sum(r["device_ms"] for r in per_level), all_levels=k1,
         stereo_pair=pair, grouped=grouped)
    return {"fast_score_nms_levels": dict(k1["frame"], on_noise=k1["noise"],
                                          stereo_pair=pair, grouped=grouped)}



def all_device_ms(fn, launches: int) -> tuple:
    """(ms, how): the mean device time of one call of fn, for a library
    call whose kernels' names are not known in advance: the durations of
    every kernel, memcpy and memset that `launches` calls issued, from
    torch.profiler's device events, over `launches`; if the profiler shows
    fewer events than calls, from a CUDA graph of the calls (graph_ms)."""
    from torch.profiler import ProfilerActivity, profile
    from multi_orbslam3_tpu_torch.profiling import common
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    events = common._device_events(prof)
    if len(events) < launches:
        return graph_ms(fn, launches), "cuda_graph"
    return sum(e[2] for e in events) / 1e6 / launches, "profiler"


def check_k2_matrix(cfg, card: dict, gen) -> dict:
    """K2 as a matrix (the tensor-core writer), with cuBLASLt's int8
    product as its yardstick: torch._int_mm on the descriptors unpacked
    once to +-1 int8 (kernels.unpack_pm1, timed as library_prep_ms) gives
    256 - 2 x the distance for the same N x M int32 output; the port never
    calls it. Kernel and library are timed in turns, twice each."""
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
        del ref
        a_pm1, b_pm1 = kernels.unpack_pm1(d1), kernels.unpack_pm1(d2)
        lib = lambda: torch._int_mm(a_pm1, b_pm1.t())
        require_equal(f"torch._int_mm {n}x{m} as distances",
                      [kernels.hamming_from_pm1_dot(lib())], [got])
        del got
        big = n * m > 2 ** 26
        reps, launches = (5, 10) if big else (15, 50)
        kern = lambda: kernels.hamming_matrix(d1, d2)
        turns = {"kernel": [], "library": []}
        for _ in range(2):
            turns["kernel"].append(device_ms(kern, "hamming_matrix_mma_kernel",
                                             launches=launches))
            turns["library"].append(all_device_ms(lib, launches))
        matrix_rows.append({
            "shape": [n, m], "max_abs_err": float(err),
            "device_ms": float(np.mean([t[0] for t in turns["kernel"]])),
            "device_ms_turns": [t[0] for t in turns["kernel"]],
            "device_ms_from": turns["kernel"][0][1],
            "call_ms": call_ms(kern, reps=reps),
            "plain_ms": call_ms(lambda: kernels.hamming_matrix_ref(d1, d2), reps=reps),
            "library": "torch._int_mm (cuBLASLt int8, +-1 operands)",
            "library_ms": float(np.mean([t[0] for t in turns["library"]])),
            "library_ms_turns": [t[0] for t in turns["library"]],
            "library_ms_from": turns["library"][0][1],
            "library_call_ms": call_ms(lib, reps=reps),
            "library_prep_ms": call_ms(lambda: (kernels.unpack_pm1(d1),
                                                kernels.unpack_pm1(d2)), reps=reps),
            **bound(card, 32.0 * (n + m) + 4.0 * n * m, hamming_pairs=float(n) * m)})
        del a_pm1, b_pm1
        torch.cuda.empty_cache()
    emit("kernel_hamming_matrix", exact=True, shapes=matrix_rows)
    return {"hamming_matrix": dict(matrix_rows[0], shapes=matrix_rows)}



# Device launches a call (kernels, memcpys, memsets) of each fused matcher
# in the parent's design, the ceiling matcher_row holds the new design to
# (profiling/k2_matchers_ab.py measures both designs' counts; PERF.md
# section 6): the validity match filled its column keys, ran its walk and
# took the keys' low words; the projection match was one walk.
PARENT_DEVICE_LAUNCHES = {"hamming_best_two_valid": 3, "hamming_best_two_projection": 1}
# the kernels of each matcher as torch.profiler names them (a substring of
# each), and how many of them a call launches (up to PROJ_CHUNK columns)
MATCHER_KERNELS = {"hamming_best_two_valid": ("valid_compact", 2),
                   "hamming_best_two_projection": ("proj_grid_kernel", 1)}


def window_pairs(c: dict) -> float:
    """The pairs a projection match's inputs need: both valid, inside the
    radius and the level window (the plain mask, counted in row blocks)."""
    n = c["proj_uv"].shape[0]
    r = c["radius"]
    r = r.expand(n) if isinstance(r, torch.Tensor) else torch.full(
        (n,), float(r), device=c["proj_uv"].device)
    total = 0
    for r0 in range(0, n, 4096):
        sl = slice(r0, r0 + 4096)
        d2 = torch.sum((c["proj_uv"][sl, None, :] - c["feat_uv"][None, :, :]) ** 2, dim=-1)
        total += int(((d2 <= r[sl, None] ** 2)
                      & ((c["feat_level"][None, :] - c["pred_level"][sl, None]).abs()
                         <= c["level_slack"])
                      & c["proj_valid"][sl, None] & c["feat_valid"][None, :]).sum())
    return float(total)


def projection_bound(card: dict, c: dict) -> dict:
    """The projection match's bound: what its inputs need read once (every
    row's and column's 1-byte flag; of the valid rows only, the 32-byte
    descriptor, the position, the predicted level and the radius, or one
    radius for all rows; of the valid columns only, descriptor, position
    and level), its outputs written once (16 bytes a row) and the
    distances of the pairs inside the windows. An invalid row or column
    needs its flag alone, and the float tests of the pairs a search
    discards are the implementation's work, not the inputs' (the earlier
    all-pairs walk's bound counted them)."""
    n, m = c["proj_uv"].shape[0], c["feat_uv"].shape[0]
    nv, mv = float(c["proj_valid"].sum()), float(c["feat_valid"].sum())
    r = c["radius"]
    per_row = isinstance(r, torch.Tensor) and r.numel() == n
    row_bytes = 32.0 + 8.0 + 4.0 + (4.0 if per_row else 0.0)
    nbytes = n + m + nv * row_bytes + (0.0 if per_row else 4.0) + mv * 44.0 + 16.0 * n
    return bound(card, nbytes, hamming_pairs=window_pairs(c))


def valid_bound(card: dict, v1: torch.Tensor, v2: torch.Tensor) -> dict:
    """The validity match's bound: every row's and column's flag read once,
    the 32-byte descriptors of the valid ones only, the outputs written
    once (idx, best and second a row: 16 bytes; the argmin row a column:
    8) and the distances of the valid pairs."""
    n, m = v1.shape[0], v2.shape[0]
    nv, mv = float(v1.sum()), float(v2.sum())
    return bound(card, n + m + 32.0 * (nv + mv) + 16.0 * n + 8.0 * m, hamming_pairs=nv * mv)


def matcher_row(card: dict, name: str, fn, plain, shape, inputs: str, b: dict,
                launches: int = 50, **extra) -> dict:
    """One timed row of a fused matcher: device_ms (its kernels' own time,
    torch.profiler), call_device_ms (a call replayed from a CUDA graph: the
    wrapper's small ops and the gaps between launches included, the host
    not), device_launches a call (the nodes of a CUDA graph of one call,
    which no lost profiler event can hide; it fails above the parent
    design's count), call_ms and plain_ms."""
    from multi_orbslam3_tpu_torch.profiling import common
    kname, per_call = MATCHER_KERNELS[name]
    ms, how = device_ms(fn, kname, launches=launches, per_call=per_call)
    n_dev = common.graph_launches(fn, torch.device("cuda"))
    if not n_dev or n_dev > PARENT_DEVICE_LAUNCHES[name]:
        raise AssertionError(f"{name} {shape} ({inputs}): {n_dev} device launches a call; "
                             f"the parent's design issued {PARENT_DEVICE_LAUNCHES[name]}")
    return {"shape": list(shape), "inputs": inputs, "max_abs_err": 0.0, "device_ms": ms,
            "device_ms_from": how,
            "call_device_ms": graph_ms(fn, launches),
            "device_launches": n_dev,
            "call_ms": call_ms(fn, reps=5),
            "plain_ms": plain() if plain is not None else None,
            "library_ms": None, **b, **extra}


def check_k2_fused(cfg, card: dict, gen) -> dict:
    """K2's fused matches: exactness on random and tie cases, then times.
    Both are held bit for bit to their plain versions."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    dev = torch.device("cuda")
    shapes = k2_shapes(cfg)
    P = cfg.map.max_mappoints
    W, H = cfg.camera.width, cfg.camera.height
    valid_rows, proj_rows = [], []
    for n, m in shapes:
        block = 2048 if n * m > 2 ** 26 else None     # bounds the plain version's memory
        for kind in ("random", "ties", "full") + (("sparse",) if n == m == P else ()):
            case = match_case(n, m, gen, dev, kind, W, H)
            d1, v1, d2, v2 = case["valid"]
            want = kernels.hamming_best_two_valid_ref(d1, v1, d2, v2, row_block=block)
            n_valid = float(v1.sum()) * float(v2.sum())
            fn = lambda: kernels.hamming_best_two_valid(d1, v1, d2, v2)
            got = fn()
            torch.cuda.synchronize()
            require_equal(f"K2 valid {n}x{m} ({kind})", got, want)
            if kind != "ties":
                plain = ((lambda: call_ms(lambda: kernels.hamming_best_two_valid_ref(
                    d1, v1, d2, v2, row_block=block), reps=3, warmup=1))
                    if kind == "random" else None)
                valid_rows.append(matcher_row(
                    card, "hamming_best_two_valid", fn, plain, (n, m), kind,
                    valid_bound(card, v1, v2),
                    launches=50 if n * m <= 2 ** 26 else 10, valid_pairs=n_valid))
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
            proj_rows.append(matcher_row(
                card, "hamming_best_two_projection", pfn,
                lambda: call_ms(lambda: kernels.hamming_best_two_projection_ref(**c), reps=5),
                (n, m), kind, projection_bound(card, c), valid_pairs=n_valid,
                window_pairs=window_pairs(c), rows_matched=matched))
    emit("kernel_hamming_best_two_valid", exact=True, shapes=valid_rows)
    emit("kernel_hamming_best_two_projection", exact=True, shapes=proj_rows)
    return {"hamming_best_two_valid": dict(valid_rows[0], shapes=valid_rows),
            "hamming_best_two_projection": dict(proj_rows[0], shapes=proj_rows)}


PROJ_EDGE_KINDS = ("cell_borders", "outside_nan_inf", "inf_radius", "slack_all",
                   "all_invalid", "one_row", "one_col", "off_tiles", "m4608", "past_launch")
VALID_EDGE_KINDS = ("all_invalid", "one_row", "one_col", "off_tiles", "ties_across_splits")
# ties_across_splits: rows in several row tiles, columns in several splits
VALID_TIE_ROWS, VALID_TIE_COLS = (10, 300, 640, 1000), (3, 250, 520, 777, 1000)


def proj_edge_shape(kind: str) -> tuple:
    """(n, m) of a projection edge case: "off_tiles" 16,385 x 1,023
    (neither a multiple of a block's rows nor its threads), "m4608"
    stereo_wide's features (one launch), "past_launch" PROJ_CHUNK + 5
    columns (two launches); the others 16,384 x 1,024."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    return {"off_tiles": (16385, 1023), "m4608": (4000, 4608),
            "past_launch": (2000, kernels.PROJ_CHUNK + 5)}.get(kind, (16384, 1024))


def proj_edge_case(kind: str, base: dict) -> dict:
    """A projection match's edge case made from `base`, the keyword
    arguments of a case at proj_edge_shape(kind) with an (n,) radius
    (cloned here, not changed): "cell_borders", pairs exactly on the radius (2.5, 3, 4, 15,
    16 px) from features on 16-px cell borders, and one float32 step
    beyond; "outside_nan_inf", features left of and below the image, a
    hair below 0, at 2^20, +-inf and NaN, and rows at NaN, inf and far
    out; "inf_radius", every third row with an infinite radius and
    features at infinity; "slack_all", the loop closer's level slack of
    every level; "all_invalid", "one_row", "one_col"; the shape kinds
    leave the base as it is. The card tests build theirs here too."""
    c = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in base.items()}
    n, m = c["mp_desc"].shape[0], c["feat_desc"].shape[0]
    dev = c["mp_desc"].device
    inf, nan = float("inf"), float("nan")
    if kind == "cell_borders":
        k = torch.arange(n, device=dev)
        c["feat_uv"] = torch.stack([16.0 * (k[:m] % 40) + 16.0,
                                    16.0 * (k[:m] % 25)], 1).float().contiguous()
        src = k % m
        r = torch.tensor([2.5, 3.0, 4.0, 15.0, 16.0], device=dev)[k % 5]
        c["radius"] = r
        uv = c["feat_uv"][src] + torch.stack([r, torch.zeros_like(r)], 1)
        uv[1::7, 0] = torch.nextafter(uv[1::7, 0], torch.full_like(uv[1::7, 0], inf))
        c["proj_uv"] = uv.contiguous()
        c["mp_desc"] = c["feat_desc"][src].clone()
        c["pred_level"] = c["feat_level"][src].clone()
        c["proj_valid"][:] = True
        c["feat_valid"][:] = True
    elif kind == "outside_nan_inf":
        c["feat_uv"][:8] = torch.tensor([[-50.0, 30.0], [400.0, 620.0], [-1e-8, 5.0],
                                         [2.0 ** 20, 1.0], [inf, 3.0], [-inf, 3.0],
                                         [nan, 4.0], [5.0, nan]], device=dev)
        c["feat_valid"][:8] = True
        c["proj_uv"][:3] = torch.tensor([[nan, 3.0], [inf, 3.0], [3e6, 3.0]], device=dev)
        c["proj_valid"][:3] = True
    elif kind == "inf_radius":
        c["radius"][::3] = inf
        c["feat_uv"][:2] = torch.tensor([[inf, 2.0], [3.0, -inf]], device=dev)
        c["feat_valid"][:2] = True
    elif kind == "slack_all":
        c["level_slack"] = 8
    elif kind == "all_invalid":
        c["proj_valid"][:] = False
    elif kind == "one_row":
        c["proj_valid"][:] = False
        c["proj_valid"][777] = True
    elif kind == "one_col":
        c["feat_valid"][:] = False
        c["feat_valid"][m - 1] = True
    return c


def valid_edge_shape(kind: str) -> tuple:
    """(n, m) of a validity edge case: "off_tiles" 1,025 x 1,031, else 1,024^2."""
    return (1025, 1031) if kind == "off_tiles" else (1024, 1024)


def valid_edge_case(kind: str, d1, v1, d2, v2) -> tuple:
    """A validity match's edge case made from a base case at
    valid_edge_shape(kind) (cloned here, not changed): "all_invalid"; "one_row",
    the last row alone valid; "one_col", the first column alone;
    "ties_across_splits", one descriptor in the rows VALID_TIE_ROWS and the
    columns VALID_TIE_COLS (each such row must take column 3 and each such
    column row 10: the (distance, index) rule across row tiles and column
    splits). Other kinds leave the base as it is."""
    d1, v1, d2, v2 = (t.clone() for t in (d1, v1, d2, v2))
    if kind == "all_invalid":
        v1[:] = False
    elif kind == "one_row":
        v1[:] = False
        v1[-1] = True
    elif kind == "one_col":
        v2[:] = False
        v2[0] = True
    elif kind == "ties_across_splits":
        rows = torch.tensor(VALID_TIE_ROWS, device=d1.device)
        cols = torch.tensor(VALID_TIE_COLS, device=d1.device)
        v1[rows] = True
        v2[cols] = True
        d2[cols] = d2[VALID_TIE_COLS[0]].clone()
        d1[rows] = d2[VALID_TIE_COLS[0]].clone()
    return d1, v1, d2, v2


def valid_ties_hold(got) -> bool:
    """ties_across_splits: the tied rows took the first tied column, and
    the tied columns the first tied row."""
    return bool((got[0][list(VALID_TIE_ROWS)] == VALID_TIE_COLS[0]).all()
                and (got[3][list(VALID_TIE_COLS)] == VALID_TIE_ROWS[0]).all())


def check_k2_edges(gen) -> None:
    """Both fused matchers bit for bit against their plain versions on the
    edge cases of proj_edge_case and valid_edge_case. The projection match
    is one launch up to PROJ_CHUNK columns."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    dev = torch.device("cuda")
    checked = []
    for kind in PROJ_EDGE_KINDS:
        n, m = proj_edge_shape(kind)
        c = proj_edge_case(kind, match_case(n, m, gen, dev, "ties", 752, 480)["projection"])
        before = kernels.launch_counts()["hamming_best_two_projection"]
        got = kernels.hamming_best_two_projection(**c)
        torch.cuda.synchronize()
        per_call = kernels.launch_counts()["hamming_best_two_projection"] - before
        if per_call != len(kernels.projection_chunks(m)):
            raise AssertionError(f"K2 projection ({kind}): {per_call} launches")
        require_equal(f"K2 projection ({kind})", got, kernels.hamming_best_two_projection_ref(**c))
        if kind == "cell_borders" and int((got[1] == 0).sum()) < 10000:
            raise AssertionError("K2 projection: pairs on the radius were not matched")
        checked.append({"kernel": "projection", "inputs": kind, "shape": [n, m],
                        "launches_per_call": per_call,
                        "rows_matched": int((got[1] < kernels.BIG).sum())})
    for kind in VALID_EDGE_KINDS:
        n, m = valid_edge_shape(kind)
        d1, v1, d2, v2 = valid_edge_case(
            kind, *match_case(n, m, gen, dev, "ties", 752, 480)["valid"])
        got = kernels.hamming_best_two_valid(d1, v1, d2, v2)
        torch.cuda.synchronize()
        require_equal(f"K2 valid ({kind})", got, kernels.hamming_best_two_valid_ref(d1, v1, d2, v2))
        if kind == "ties_across_splits" and not valid_ties_hold(got):
            raise AssertionError("K2 valid: the tied rows and columns did not take the first")
        checked.append({"kernel": "valid", "inputs": kind, "shape": [n, m],
                        "rows_matched": int((got[1] < kernels.BIG).sum())})
    emit("kernel_k2_edge_cases", exact=True, cases=checked)


def check_k2_captured(card: dict, cases: dict) -> dict:
    """Both fused matchers on inputs the slice's warm-up pass gave them
    (K2Capture): the 60th coarse tracking call
    (16,384 landmarks x 1,024 features, features clustered as a real frame
    has them) and the first keyframe-pair triangulation after it; bit for
    bit against the plain versions, timed, with their bounds."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    rows = {}
    if set(cases) != {"tracking_coarse", "triangulation"}:
        raise AssertionError(f"the slice's warm-up pass captured {sorted(cases)}")
    c = cases["tracking_coarse"]
    pfn = lambda: kernels.hamming_best_two_projection(**c)
    got = pfn()
    torch.cuda.synchronize()
    require_equal("K2 projection (captured tracking call)", got,
                  kernels.hamming_best_two_projection_ref(**c))
    n, m = c["mp_desc"].shape[0], c["feat_desc"].shape[0]
    rows["hamming_best_two_projection"] = [matcher_row(
        card, "hamming_best_two_projection", pfn,
        lambda: call_ms(lambda: kernels.hamming_best_two_projection_ref(**c), reps=5),
        (n, m), "captured: coarse tracking, frame 60", projection_bound(card, c),
        valid_pairs=float(c["proj_valid"].sum()) * float(c["feat_valid"].sum()),
        window_pairs=window_pairs(c), rows_matched=int((got[1] < kernels.BIG).sum()))]
    t = cases["triangulation"]
    vfn = lambda: kernels.hamming_best_two_valid(**t)
    got = vfn()
    torch.cuda.synchronize()
    require_equal("K2 valid (captured triangulation call)", got,
                  kernels.hamming_best_two_valid_ref(**t))
    n, m = t["d1"].shape[0], t["d2"].shape[0]
    n_valid = float(t["valid1"].sum()) * float(t["valid2"].sum())
    rows["hamming_best_two_valid"] = [matcher_row(
        card, "hamming_best_two_valid", vfn,
        lambda: call_ms(lambda: kernels.hamming_best_two_valid_ref(**t), reps=5),
        (n, m), "captured: keyframe-pair triangulation",
        valid_bound(card, t["valid1"], t["valid2"]),
        valid_pairs=n_valid)]
    emit("kernel_k2_captured", exact=True, **rows)
    return rows


def stereo_case(n: int, m: int, gen, dev, kind: str, width: int, height: int) -> dict:
    """Inputs of the stereo match at n x m: left rows near the right
    columns they were made from, about 25% of each invalid. "ties": also
    every 7th column a copy of its neighbour, rows that copy columns, one
    fully masked row and column. "tolerance": each left feature sits
    exactly on the row tolerance of its level, one float32 step beyond it,
    or at disparity exactly 0.3, 128 or one step inside, relative to its
    right feature (integer right positions keep most differences exact).
    "reversed_ties" (the row-band search's trap): "ties", and five right
    columns far apart in index share one descriptor, one image row and one
    level, so that they reach a row's search out of column order, and
    every 6th left row copies that descriptor onto that row.
    "empty_band": "random", and a fifth of the left rows sit on an image
    row whose band holds no right feature, with rows at the image's first
    and last row matching right features there, one of them only through
    float rounding, from one row below the band's exact edge."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    rint = lambda lo, hi, k: torch.randint(lo, hi, (k,), generator=gen, device=dev)
    dL, dR = random_words(n, gen, dev), random_words(m, gen, dev)
    vL, vR = rnd(n) < 0.75, rnd(m) < 0.75
    uvR = torch.round(rnd(m, 2) * torch.tensor([width, height], device=dev))
    levelR = rint(0, 8, m).to(torch.int32)
    src = rint(0, m, n)
    if kind in ("ties", "reversed_ties"):
        k = dR[7::7].shape[0]
        dR[7::7] = dR[6:-1:7][:k].clone()
        uvR[7::7] = uvR[6:-1:7][:k].clone()
        vL[min(3, n - 1)] = False
        vR[min(2, m - 1)] = False
    if kind == "empty_band":
        uvR[:8, 1] = 0.0
        uvR[8:16, 1] = float(height - 1)
        src[:16] = torch.arange(16, device=dev)
        vR[:16] = True
        vL[:16] = True
        empty_row = float(height) * 0.8 + 0.5
        uvR[(uvR[:, 1] - empty_row).abs() < 12, 1] = 10.0
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
    if kind == "empty_band":
        uvL[:16] = uvR[:16] + torch.tensor([20.0, 0.0], device=dev)
        dL[:16] = dR[:16]
        levelL[:16] = levelR[:16]
        tol[:16] = kernels.stereo_row_tolerance(levelL[:16], 2.0)
        uvL[n // 5:2 * n // 5, 1] = empty_row
        # fl(tol - vR) rounds to tol: the pair passes from one row below the
        # band's exact edge
        uvR[0, 1] = -1e-8
        uvL[0, 1] = tol[0]
    if kind == "reversed_ties":
        dup = torch.tensor([10, m // 3, m // 3 + 1, m // 2, m - 1], device=dev)
        dR[dup] = dR[10].clone()
        uvR[dup] = torch.stack([100.0 + torch.arange(5, device=dev, dtype=torch.float32),
                                torch.full((5,), 200.0, device=dev)], 1)
        levelR[dup] = 3
        vR[dup] = True
        rows = torch.arange(0, n, 6, device=dev)
        dL[rows] = dR[10]
        uvL[rows] = torch.tensor([180.0, 200.5], device=dev)
        levelL[rows] = 3
        tol[rows] = kernels.stereo_row_tolerance(levelL[rows], 2.0)
        vL[rows] = True
    return dict(descL=dL, uvL=uvL.contiguous(), validL=vL, levelL=levelL, tol=tol,
                descR=dR, uvR=uvR.contiguous(), validR=vR, levelR=levelR,
                max_disparity=128.0)


def check_k2_stereo(cfg, card: dict, gen) -> dict:
    """K2's stereo match, the row-band search (csrc/stereo_band.cu), at the
    stereo frame's shape (features x features): exactness on random, tie,
    on-the-tolerance, out-of-column-order tie and empty-band cases, then
    times, a KITTI-size pair (4,096 features a side, 1241 x 376) for how
    the time grows, and past one launch's 4,096 right features, in column
    chunks: stereo_wide's 4,608 a side at 752 x 480 and 8,192 a side at
    1241 x 376. The bound counts the pairs that pass the float mask
    (their products) and the float tests of the pairs within a row's
    tolerance (the pairs a row-indexed search has to test)."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    dev = torch.device("cuda")
    n = m = cfg.orb.n_features
    W, H = cfg.camera.width, cfg.camera.height
    rows = []
    cases = [(n, m, W, H, kind) for kind in ("random", "ties", "tolerance", "reversed_ties",
                                             "empty_band")]
    cases += [(4096, 4096, 1241, 376, "random"), (4608, 4608, W, H, "random"),
              (8192, 8192, 1241, 376, "random")]
    for n_, m_, w_, h_, kind in cases:
        c = stereo_case(n_, m_, gen, dev, kind, w_, h_)
        fn = lambda: kernels.hamming_best_two_stereo(**c)
        per_call = len(kernels.stereo_chunks(m_))
        before = kernels.launch_counts()["hamming_best_two_stereo"]
        got = fn()
        torch.cuda.synchronize()
        if kernels.launch_counts()["hamming_best_two_stereo"] - before != per_call:
            raise AssertionError(f"K2 stereo {n_}x{m_}: not {per_call} launches")
        require_equal(f"K2 stereo {n_}x{m_} ({kind})", got,
                      kernels.hamming_best_two_stereo_ref(**c))
        matched = int((got[1] < kernels.BIG).sum())
        if matched == 0 or matched == n_:
            raise AssertionError(f"K2 stereo {n_}x{m_} ({kind}): {matched} of {n_} rows "
                                 "have a pair in their window")
        if kind == "reversed_ties":
            tied = torch.arange(0, n_, 6, device=dev)
            if not ((got[0][tied] == 10).all() and (got[1][tied] == 0).all()
                    and (got[2][tied] == 0).all()):
                raise AssertionError("K2 stereo: the tied rows did not take column 10")
        if kind == "empty_band" and not (got[1][n_ // 5:2 * n_ // 5] == kernels.BIG).all():
            raise AssertionError("K2 stereo: a row with an empty band found a pair")
        if kind == "ties":
            continue
        # pairs that pass the mask, from the plain arithmetic
        dv = (c["uvL"][:, None, 1] - c["uvR"][None, :, 1]).abs()
        disp = c["uvL"][:, None, 0] - c["uvR"][None, :, 0]
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        both = c["validL"][:, None] & c["validR"][None, :]
        in_band = (dv <= c["tol"][:, None]) & both
        passing = float((in_band & (disp > f32(0.3)) & (disp < f32(128.0))
                         & ((c["levelL"][:, None] - c["levelR"][None, :]).abs() <= 1)).sum())
        band = float(in_band.sum())
        n_valid = float(both.sum())
        del dv, disp, both, in_band
        ms, how = device_ms(fn, "stereo_band_kernel", per_call=per_call)
        rows.append({
            "shape": [n_, m_], "image": [w_, h_], "inputs": kind,
            "launches_per_call": per_call, "valid_pairs": n_valid,
            "band_pairs": band, "window_pairs": passing, "rows_matched": matched,
            "max_abs_err": 0.0, "device_ms": ms, "device_ms_from": how,
            "call_ms": call_ms(fn),
            "plain_ms": call_ms(lambda: kernels.hamming_best_two_stereo_ref(**c), reps=5),
            "library_ms": None,
            # a pair within the band: 2 subtractions and an abs, then 3 compares
            **bound(card, 49.0 * n_ + 45.0 * m_ + 16.0 * n_, hamming_pairs=passing,
                    fp32_instr=3.0 * band, minmax_instr=3.0 * band)})
    emit("kernel_hamming_best_two_stereo", exact=True, shapes=rows)
    return {"hamming_best_two_stereo": dict(
        rows[0], shapes=rows, chunked=[r for r in rows if r["launches_per_call"] > 1])}


def pose_case(m: int, stereo: bool, gen, dev) -> dict:
    """m observations of points 2-16 m ahead of a pose 3 cm / 0.03 rad off
    the identity start, level-scaled pixel noise, 10% gross outliers, 10%
    masked and 2% behind the camera; stereo right-u on every row or none."""
    from multi_orbslam3_tpu_torch.geometry import camera as cam
    from multi_orbslam3_tpu_torch.geometry import se3
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    K = cam.PinholeK(*(torch.tensor(v, device=dev) for v in (458.654, 457.296, 376.0, 240.0)))
    pts = torch.stack([rand(m) * 12 - 6, rand(m) * 8 - 4, rand(m) * 14 + 2], 1)
    xi = (rand(6) - 0.5) * 0.06
    T_true = se3.exp(xi)
    back = rand(m) < 0.02
    p_world = se3.apply(se3.inverse(T_true), torch.where(
        back[:, None], pts * torch.tensor([1.0, 1.0, -1.0], device=dev), pts)).contiguous()
    level = torch.floor(rand(m) * 8)
    scale = torch.pow(1.2, level)
    uv = cam.project(K, pts) + torch.randn((m, 2), generator=gen, device=dev) * scale[:, None]
    uv = torch.where((rand(m) < 0.1)[:, None], uv + (rand(m, 2) - 0.5) * 80, uv).contiguous()
    bf = 0.11 * 458.654
    return dict(T_init=torch.eye(4, device=dev), K=K, p_world=p_world, uv_obs=uv,
                inv_sigma2=1.0 / (scale * scale), mask=rand(m) >= 0.1,
                u_r=(uv[:, 0] - bf / pts[:, 2]).contiguous() if stereo else None,
                bf=bf if stereo else 0.0)


def pose_opt_with_fma():
    """csrc/pose_opt.cu built as kernels.build() builds it but with fused
    multiply-adds on (without its SOURCE_FLAGS): its C entry, typed as the
    wrapper's, for the time that the kernel's -fmad=false costs."""
    import ctypes
    from multi_orbslam3_tpu_torch.frontend import kernels
    out = kernels.BUILD_DIR / "pose_opt_fma.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(kernels.CSRC / "pose_opt.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).mo3_pose_optimization
    real = kernels._lib().pose_optimization
    fn.argtypes, fn.restype = real.argtypes, real.restype
    return fn


def check_pose_opt(card: dict, gen) -> dict:
    """The motion-only pose optimisation in one launch (csrc/pose_opt.cu)
    at the tracking call's shape and at 2,000 mono rows: bit for bit its
    CPU model on the card, near its plain version, one launch a call, then
    device_ms (profiler), call_ms (opt/pose_opt.pose_optimization, the
    intrinsics' stack included) and plain_ms. The bound is the latency of
    rounds x iters dependent iterations (a block reduction, a 6 x 6 solve
    in one thread, two barriers each), not the bytes it reads once.
    device_ms_fma is the same source built with fused multiply-adds on
    (pose_opt_with_fma), fma_centre_m its centre's distance from the
    kernel's, fma_equals_model whether it still equals the CPU model."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    from multi_orbslam3_tpu_torch.opt import pose_opt
    dev = torch.device("cuda")
    lib, with_fma = kernels._lib(), pose_opt_with_fma()
    centre = lambda T: -(T[:3, :3].T @ T[:3, 3])  # noqa: E731
    rows = []
    for m, stereo, rounds, iters in ((1280, True, 2, 7), (2000, False, 4, 10)):
        c = pose_case(m, stereo, gen, dev)
        fn = lambda: pose_opt.pose_optimization(**c, rounds=rounds, iters=iters)  # noqa: E731
        before = kernels.launch_counts()["pose_optimization"]
        got = fn()
        torch.cuda.synchronize()
        if kernels.launch_counts()["pose_optimization"] != before + 1:
            raise AssertionError(f"pose optimisation {m}: not one launch a call")
        require_equal(f"pose optimisation {m} (against its CPU model on the card)", got,
                      pose_opt.pose_opt_kernel_model(**c, rounds=rounds, iters=iters))
        want = pose_opt.pose_optimization_ref(**c, rounds=rounds, iters=iters)
        dc = float(torch.linalg.norm(centre(got.pose) - centre(want.pose)))
        apart = got.inliers != want.inliers
        near = torch.zeros_like(apart)
        for T in (got.pose, want.pose):        # rows within 1e-4 of their threshold
            r = pose_opt._residual_jac(T, c["K"], c["p_world"], c["uv_obs"], c["u_r"],
                                       c["bf"])[0]
            chi2 = torch.sum(r * r, dim=-1) * c["inv_sigma2"]
            th = torch.full_like(chi2, 5.991) if c["u_r"] is None else torch.where(
                c["u_r"] >= 0, 7.815, 5.991)
            near |= torch.abs(chi2 - th) <= 1e-4 * th
        differ = int(apart.sum())
        if dc > 1e-5 or bool((apart & ~near).any()):
            raise AssertionError(f"pose optimisation {m}: centre {dc} m from the plain "
                                 f"version's, {differ} inlier flags differ")
        nbytes = m * (12 + 8 + 4 + 1 + (4 if stereo else 0) + 1) + 64 + 16 + 72
        ms, how = device_ms(fn, "pose_opt_kernel")
        lib.pose_optimization, without_fma = with_fma, lib.pose_optimization
        try:
            got_fma = fn()
            ms_fma, _ = device_ms(fn, "pose_opt_kernel")
        finally:
            lib.pose_optimization = without_fma
        fma_centre = float(torch.linalg.norm(centre(got_fma.pose) - centre(got.pose)))
        rows.append({
            "shape": [m], "inputs": ("stereo" if stereo else "mono") + f", {rounds} x {iters}",
            "launches_per_call": 1, "device_launches": device_launches(fn),
            "inliers": int(got.n_inliers), "centre_err_m": dc, "inliers_differ": differ,
            "max_abs_err": 0.0, "device_ms": ms, "device_ms_from": how,
            "us_per_iteration": 1e3 * ms / (rounds * iters + rounds),
            "device_ms_fma": ms_fma, "fma_centre_m": fma_centre,
            "fma_equals_model": all(torch.equal(a, b) for a, b in zip(got_fma, got)),
            "call_ms": call_ms(fn), "plain_ms": call_ms(lambda: pose_opt.pose_optimization_ref(
                **c, rounds=rounds, iters=iters), reps=5),
            "bytes": nbytes, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_ms": None, "bound_by": "latency",
            "limit": f"{rounds * iters} dependent iterations and {rounds} classifications"})
    emit("kernel_pose_optimization", exact_to_model=True, shapes=rows)
    return {"pose_optimization": dict(rows[0], shapes=rows)}


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


def check_k2_arena(card: dict, gen, n_agents: int = 2) -> dict:
    """K2's fused matches at the collaborative server's arena shapes (the
    synthetic_mono config, 2 agents: 32768 landmarks, 1024 features): the
    validity match at 32768 x 32768, as the verification cascade's
    match_loop_landmarks runs it, with about 4% valid (the cascade's
    region masks) and about 75% valid; the projection match at 32768 x
    1024, as the arena fuse runs it. The plain validity version goes 2048
    rows at a time (a full 32768^2 int32 matrix is 4 GiB) and every case is
    freed before the next."""
    from multi_orbslam3_tpu_torch import config as cfgm
    from multi_orbslam3_tpu_torch.frontend import kernels
    dev = torch.device("cuda")
    c = cfgm.synthetic_mono()
    P, n_feat = c.map.max_mappoints * n_agents, c.orb.n_features
    W, H = c.camera.width, c.camera.height
    rows = {"hamming_best_two_valid": [], "hamming_best_two_projection": []}
    for kind in ("sparse", "random"):
        case = match_case(P, P, gen, dev, kind, W, H)
        d1, v1, d2, v2 = case["valid"]
        del case
        want = kernels.hamming_best_two_valid_ref(d1, v1, d2, v2, row_block=2048)
        torch.cuda.synchronize()
        plain = call_ms(lambda: kernels.hamming_best_two_valid_ref(
            d1, v1, d2, v2, row_block=2048), reps=1, warmup=0)
        n_valid = float(v1.sum()) * float(v2.sum())
        fn = lambda: kernels.hamming_best_two_valid(d1, v1, d2, v2)
        got = fn()
        torch.cuda.synchronize()
        require_equal(f"K2 valid {P}x{P} ({kind})", got, want)
        rows["hamming_best_two_valid"].append(matcher_row(
            card, "hamming_best_two_valid", fn, lambda: plain, (P, P), kind,
            valid_bound(card, v1, v2),
            launches=5, valid_pairs=n_valid))
        del want, got, d1, v1, d2, v2
        torch.cuda.empty_cache()
    c_p = match_case(P, n_feat, gen, dev, "random", W, H)["projection"]
    pfn = lambda: kernels.hamming_best_two_projection(**c_p)
    got = pfn()
    torch.cuda.synchronize()
    require_equal(f"K2 projection {P}x{n_feat}", got,
                  kernels.hamming_best_two_projection_ref(**c_p))
    n_valid = float(c_p["proj_valid"].sum()) * float(c_p["feat_valid"].sum())
    rows["hamming_best_two_projection"].append(matcher_row(
        card, "hamming_best_two_projection", pfn,
        lambda: call_ms(lambda: kernels.hamming_best_two_projection_ref(**c_p), reps=5),
        (P, n_feat), "random", projection_bound(card, c_p), valid_pairs=n_valid,
        window_pairs=window_pairs(c_p)))
    emit("kernel_hamming_arena_shapes", exact=True, **rows)
    return rows


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
    rows.update(check_pose_opt(card, gen))
    for name, arena in check_k2_arena(card, gen).items():
        rows[name]["arena_shapes"] = arena
    check_k2_edges(gen)
    check_matcher_memory(cfg, gen)
    return rows


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def drive_mono(cfg, seq, device: str, loop_closing: bool,
               warmup: bool = True, warmup_ctx=None) -> tuple:
    """Warm-up pass, then a timed pass on a fresh system, as _drive_mono
    does; the next frame's upload is issued before the current frame.
    warmup_ctx: a context manager entered around the warm-up pass alone."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam
    F = seq.images.shape[0]
    for timed in ((False, True) if warmup else (True,)):
        ctx = warmup_ctx if (warmup_ctx is not None and not timed) else contextlib.nullcontext()
        ctx.__enter__()
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
        ctx.__exit__(None, None, None)
    return slam, np.asarray(frame_ms), wall, kernels.launch_counts()


def phase_sync_free(cfg, slam, seq, stereo_cfg, stereo_slam, stereo_seq, server,
                    vi_server, wide_slam) -> None:
    """The fused step (mono, stereo, and stereo at stereo_wide's 4,608
    features and 9 levels: two K1 launches and two seeded stereo chunks),
    the mapping chain, the
    place-recognition step, one global-BA step on the collaborative
    server's final arena and one joint visual-inertial window solve on the
    inertial collaboration's launch their work without one device->host
    read: all run under torch's sync debug mode "error". The window's
    inputs are assembled before (CollabServer._vi_window_inputs reads the
    keyframe timestamps once, on the host's side of the pair gate); after
    the solve, _vi_window reads the device once for its gates and the
    velocities the host rows keep."""
    from multi_orbslam3_tpu_torch.opt import global_ba, inertial_ba
    from multi_orbslam3_tpu_torch.pipeline import local_mapping, loop_closing, tracking
    from multi_orbslam3_tpu_torch.utils.padding import pow2_len
    start_phase()
    obs, K_obs, fixed, _, _ = server._assemble_gba()
    obs, K_obs = server._valid_rows(obs, K_obs)
    fixed_d = torch.from_numpy(fixed).cuda()
    img = slam.to_device(seq.images[-1])
    T_cur = slam._upload(slam.T_cur)
    T_vel = slam._upload(slam.T_vel)
    k = int(slam.m.n_kf) - 1
    lc = slam.loop_closer
    il = stereo_slam.to_device(stereo_seq.images[-1])
    ir = stereo_slam.to_device(stereo_seq.images_right[-1])
    Ts_cur = stereo_slam._upload(stereo_slam.T_cur)
    Ts_vel = stereo_slam._upload(stereo_slam.T_vel)
    wide_cfg = stereo_wide_config()
    wl = wide_slam.to_device(stereo_seq.images[WIDE_FRAMES - 1])
    wr = wide_slam.to_device(stereo_seq.images_right[WIDE_FRAMES - 1])
    Tw_cur = wide_slam._upload(wide_slam.T_cur)
    Tw_vel = wide_slam._upload(wide_slam.T_vel)
    own = np.nonzero(vi_server.m.kf_valid.cpu().numpy()
                     & (vi_server.m.kf_agent.cpu().numpy() == 0))[0]
    book = vi_server.agents[0]
    vi = vi_server._vi_window_inputs(
        own, pow2_len(len(own), lo=16), book.T_bc, np.array([0.0, 0.0, -cfg.imu.gravity], np.float32),
        n_fixed=1, n_pts=min(4096, vi_server.m.max_mp))
    if vi is None:
        raise AssertionError("sync_free: the inertial arena has no usable window")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tracking.fused_step_chained(cfg, slam.m, img, T_cur, T_vel)
        tracking.fused_step_stereo_chained(stereo_cfg, stereo_slam.m, il, ir,
                                           Ts_cur, Ts_vel)
        tracking.fused_step_stereo_chained(wide_cfg, wide_slam.m, wl, wr, Tw_cur, Tw_vel)
        local_mapping.map_keyframe(slam.m, k, slam.K,
                                   **local_mapping.mapping_kwargs(cfg))
        loop_closing._pr_step(lc.db, lc.voc, slam.m, k)
        global_ba.global_bundle_adjust(server.m.kf_pose, fixed_d, server.m.mp_pos,
                                       server.m.mp_valid, obs, K_obs, iters=1)
        inertial_ba.inertial_bundle_adjust(**vi["solve"], iters=1, fix_points=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit("sync_free", fused_step_chained=True, fused_step_stereo_chained=True,
         fused_step_stereo_chained_wide=True,
         map_keyframe=True, pr_step=True, global_bundle_adjust=True,
         inertial_bundle_adjust=True, vi_window_keyframes=len(own))


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
                   both_fused: bool = False, stereo_expected=None,
                   pose_expected=None) -> None:
    """K1, a fused K2 kernel and the pose optimisation must have been
    launched on the path: K1 exactly k1_expected times where that is given
    (once a frame), with both_fused the validity and the projection match
    each at least once, the stereo match exactly stereo_expected times and
    the pose optimisation exactly pose_expected times where given."""
    pose = launches["pose_optimization"]
    if pose <= 0 or (pose_expected is not None and pose != pose_expected):
        problems.append(f"the pose optimisation was launched {pose} times on this path"
                        + (f", not {pose_expected}" if pose_expected is not None else ""))
    if stereo_expected is not None and \
            launches["hamming_best_two_stereo"] != stereo_expected:
        problems.append(f"K2's stereo match was launched "
                        f"{launches['hamming_best_two_stereo']} times on this path, "
                        f"not {stereo_expected}")
    k1 = launches["fast_score_nms_levels"]
    if k1 <= 0 or (k1_expected is not None and k1 != k1_expected):
        problems.append(f"K1 was launched {k1} times on this path"
                        + (f", not {k1_expected}" if k1_expected is not None else ""))
    valid = launches["hamming_best_two_valid"]
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
    # K2's real inputs, from the warm-up pass (check_k2_captured)
    recorder = K2Capture() if loop_closing else None
    slam, frame_ms, wall, launches = drive_mono(cfg, seq, device, loop_closing,
                                                warmup=loop_closing, warmup_ctx=recorder)
    if recorder is not None:
        CAPTURED.update(recorder.cases)
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


class PhaseFailed(AssertionError):
    """A phase's gates failed; `res` holds what the phase printed, `state`
    what it hands to later phases (or None)."""

    def __init__(self, name: str, res: dict, problems: list, state=None):
        super().__init__(f"{name}: " + "; ".join(problems))
        self.res = res
        self.state = state


def finish_phase(name: str, res: dict, problems: list, state=None) -> dict:
    emit(name, **res)
    if problems:
        raise PhaseFailed(name, res, problems, state)
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
    # the first frame builds the map; each later one is tracked by the
    # fused step, two pose optimisations, and none falls back here
    check_launches(launches, problems, k1_expected=F, both_fused=True, stereo_expected=F,
                   pose_expected=2 * (F - 1))
    if slam.state != TrackState.OK:
        problems.append(f"final state {slam.state.name}")
    if len(states) != F or len(ok_idx) < 70:
        problems.append(f"{len(ok_idx)} of {F} frames OK (< 70), {len(states)} logged")
    if not ate_rmse <= 0.02 * span:
        problems.append(f"ATE without scale alignment {ate_rmse:.4f} m > 0.02 x span "
                        f"{span:.3f} m")
    return finish_phase("stereo", res, problems), slam


# the stereo_wide cell: 4,608 ORB features over 9 levels, past one launch
# of the stereo match (kernels.STEREO_CHUNK right features) and, for the
# pair's 18 levels, of K1 (kernels.MAX_LEVELS); the map holds every
# observation of a keyframe and more landmarks than 20 frames create
WIDE_FEATURES, WIDE_LEVELS, WIDE_FRAMES = 4608, 9, 20
WIDE_MAX_MAPPOINTS, WIDE_MAX_OBS = 32768, 262144
# profiling/jax_stereo_wide_cpu.py: the JAX package on the same cell, on a
# CPU (frames OK of 20, ATE without scale alignment / span)
WIDE_REFERENCE = {"frames_ok": 20, "ate_rmse_no_scale": 0.010085974970331845,
                  "span": 1.5763484239578247, "ate_over_span": 0.0063983157638515175}


def stereo_wide_config():
    from multi_orbslam3_tpu_torch import config as cfgm
    return euroc_scale_config(baseline=0.11).replace(
        sensor="stereo", orb=cfgm.ORBConfig(n_features=WIDE_FEATURES, n_levels=WIDE_LEVELS),
        map=cfgm.MapConfig(max_mappoints=WIDE_MAX_MAPPOINTS, max_obs=WIDE_MAX_OBS,
                           max_obs_per_kf=WIDE_FEATURES))


def phase_stereo_wide(seq, device: str = "cuda") -> tuple:
    """bench_stereo's first 20 frames at 4,608 features and 9 levels
    (stereo_wide_config): StereoSlam with loop closing on through
    process_frame_stereo_pipelined. Gates, bench_stereo's limits for 20
    frames: >= 18 frames OK and ATE without scale alignment <= 0.02 x span;
    K1 and the stereo match each launched twice a frame (two groups of 9
    levels, two column chunks). Then, on frame 0's own inputs on the card,
    K1 over the pair's 18 levels and the stereo match of its two feature
    sets, each against its plain version bit for bit (these launches are
    not counted)."""
    from multi_orbslam3_tpu_torch.frontend import extractor, kernels, pyramid
    from multi_orbslam3_tpu_torch.pipeline import StereoSlam, TrackState
    start_phase()
    cfg = stereo_wide_config()
    F = WIDE_FRAMES
    slam = StereoSlam(cfg, enable_loop_closing=True, device=device)
    frame_ms, wall, launches = run_frames(
        slam, F, lambda i: slam.process_frame_stereo_pipelined(
            seq.images[i], seq.images_right[i], float(seq.timestamps[i])))
    states = [st for _, st in slam.frame_log]
    ok_idx = [i for i, st in enumerate(states) if st == TrackState.OK]
    ate_rmse, span = ate_of(slam, seq, ok_idx, with_scale=False)
    k1_per_frame = len(kernels.even_groups(2 * WIDE_LEVELS, kernels.MAX_LEVELS))
    stereo_per_frame = len(kernels.stereo_chunks(WIDE_FEATURES))
    # the kernels on frame 0's own inputs
    il, ir = slam.to_device(seq.images[0]), slam.to_device(seq.images_right[0])
    o = cfg.orb
    levels = [im.contiguous() for img in (il, ir)
              for im in pyramid.build_pyramid(img.float(), o.n_levels, o.scale_factor)]
    require_equal("stereo_wide K1 (frame 0, 18 levels)",
                  kernels.fast_score_nms_levels(levels, o.fast_threshold_min),
                  kernels.fast_score_nms_levels_ref(levels, o.fast_threshold_min))
    fl, fr = extractor.extract_features_pair(il, ir, cfg)
    levelL = fl.level.to(torch.int32).contiguous()
    args = dict(descL=fl.desc.contiguous(), uvL=fl.uv_und.contiguous(),
                validL=fl.valid.contiguous(), levelL=levelL,
                tol=kernels.stereo_row_tolerance(levelL, 2.0), descR=fr.desc.contiguous(),
                uvR=fr.uv_und.contiguous(), validR=fr.valid.contiguous(),
                levelR=fr.level.to(torch.int32).contiguous(), max_disparity=128.0)
    got = kernels.hamming_best_two_stereo(**args)
    torch.cuda.synchronize()
    require_equal("stereo_wide stereo match (frame 0)", got,
                  kernels.hamming_best_two_stereo_ref(**args))
    res = {"frames": F, "frames_ok": len(ok_idx), "state": slam.state.name,
           "n_features": WIDE_FEATURES, "n_levels": WIDE_LEVELS,
           "valid_features_frame0": [int(fl.valid.sum()), int(fr.valid.sum())],
           "frame0_rows_matched": int((got[1] < kernels.BIG).sum()),
           "kf_inserted": slam.stats["kf_inserted"], "mp_created": slam.stats["mp_created"],
           "mp_valid": int(slam.m.mp_valid.sum()), "max_mappoints": WIDE_MAX_MAPPOINTS,
           "loops_closed": slam.loop_closer.loops_closed, "ate_rmse_no_scale": ate_rmse,
           "span": span, "ate_over_span": ate_rmse / span,
           "k1_launches_per_frame": launches["fast_score_nms_levels"] / F,
           "stereo_launches_per_frame": launches["hamming_best_two_stereo"] / F,
           "frame0_kernels_exact": True, "reference_jax_cpu": WIDE_REFERENCE,
           **latency_stats(frame_ms, wall), "launches": launches}
    problems = []
    check_launches(launches, problems, k1_expected=k1_per_frame * F, both_fused=True,
                   stereo_expected=stereo_per_frame * F, pose_expected=2 * (F - 1))
    if res["mp_valid"] >= WIDE_MAX_MAPPOINTS:
        problems.append("the map's landmark capacity filled")
    if len(ok_idx) < F - 2:
        problems.append(f"{len(ok_idx)} of {F} frames OK (< {F - 2})")
    if not ate_rmse <= 0.02 * span:
        problems.append(f"ATE without scale alignment {ate_rmse:.4f} m > 0.02 x span "
                        f"{span:.3f} m")
    return finish_phase("stereo_wide", res, problems), slam


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
    check_launches(launches, problems, k1_expected=n_frames, stereo_expected=0,
                   pose_expected=2 * (n_frames - 1))
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


def gn_step_ms(server, device: str = "cuda") -> dict:
    """One Gauss-Newton step with 40 CG iterations on the server's final
    arena, on the valid rows of its observation list as the server solves
    (CUDA events, after one warm-up step), with that count of rows and the
    full list's."""
    from multi_orbslam3_tpu_torch.opt import global_ba
    obs, K_obs, fixed, _, _ = server._assemble_gba()
    rows = int(obs.valid.numel())
    obs, K_obs = server._valid_rows(obs, K_obs)
    m = server.m
    fixed_d = torch.from_numpy(fixed).to(device)
    step = lambda: global_ba.global_bundle_adjust(m.kf_pose, fixed_d, m.mp_pos, m.mp_valid,
                                                  obs, K_obs, iters=1, cg_iters=40)
    step()
    sync(device)
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        sync(device)
        times.append(start.elapsed_time(end))
    return {"gn_step_ms": float(np.median(times)), "gn_step_ms_all": times,
            "obs_rows": rows, "obs_valid": int(obs.valid.sum())}


def phase_collab(device: str = "cuda", n_frames: int = 150, config=None,
                 deterministic: bool = False, on_cycle=None, seed: int = 31) -> tuple:
    """bench_collab (eval/benchmarks.py:186-287) on the port: two
    CollabClients of monocular agents and a CollabServer over
    InProcessTransport, the synthetic_mono config (640x480, 1024 features,
    8 levels; per agent 512 keyframes and 16384 landmarks, so the arena
    holds 1024 and 32768), the bundled k=10 L=5 vocabulary, 150 frames an
    agent of a circular orbit (1200 points, seed 31, phase 1.1 + 0.55 a,
    arc 2.3 pi), GBA on events and periodic, drain_gba at the end. One
    timed pass (the JAX bench's warm-up pass is dropped). Scored on each
    agent's server-arena keyframes matched to ground truth by timestamp.
    deterministic sets the server's flag of that name; seed the sequence's;
    on_cycle(i, server, clients, seqs) is called after each server cycle
    and, with i = F, after drain_gba (profiling/torch_collab_runs.py
    --trace). Without on_cycle the phase keeps its own merge record
    (profiling/collab_merge_record.py, cycles off) and prints its summary
    as `merge_record`: each accepted merge's RANSAC inliers, n_proj and
    Sim3 error against ground truth, and agent 1's median own-landmark
    inliers over the 20 frames before and after the first merge."""
    from multi_orbslam3_tpu_torch import config as cfgm
    from multi_orbslam3_tpu_torch.collab import CollabClient, CollabServer, codec
    from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.eval import ate
    from multi_orbslam3_tpu_torch.frontend import kernels
    from multi_orbslam3_tpu_torch.pipeline import loop_closing as lcm
    from multi_orbslam3_tpu_torch.pipeline.system import TrackState
    if device == "cuda":
        start_phase()
    c = config or cfgm.synthetic_mono()
    n_agents, F = 2, n_frames
    seqs = [synthetic.make_sequence(c, n_frames=F, n_points=1200, seed=seed,
                                    trajectory="circle", phase=1.1 + 0.55 * a,
                                    arc=2.3 * np.pi) for a in range(n_agents)]
    tr = InProcessTransport()
    clients = [CollabClient(c, a, tr, device=device) for a in range(n_agents)]
    server = CollabServer(c, tr, n_agents=n_agents, device=device)
    server.deterministic = deterministic
    warm_torch_func(device)
    record = None
    if on_cycle is None:
        on_cycle = record = profiling_module("collab_merge_record").MergeRecord(
            lcm, cycles=False)
    timer = StageTimes(lcm, ["verify_candidate_cascade", "correct_loop"])
    if record is not None:
        record.install(server, clients, seqs)   # inside the timer: closed first
    states = [[] for _ in range(n_agents)]
    server_launches = collections.Counter()
    cycle_events = []
    sync(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(F):
        for a, cl in enumerate(clients):
            states[a].append(cl.process_frame(seqs[a].images[i], float(seqs[a].timestamps[i])))
            cl.comm_cycle()
        before = kernels.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        server.comm_cycle()
        end.record()
        cycle_events.append((start, end))
        server_launches.update({k: v - before[k] for k, v in kernels.launch_counts().items()})
        if on_cycle is not None:
            on_cycle(i, server, clients, seqs)
    server.drain_gba()
    if on_cycle is not None:
        on_cycle(F, server, clients, seqs)
    sync(device)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if hasattr(on_cycle, "close"):
        on_cycle.close()        # before the timer: it wraps the timer's wrapper
    stages = timer.close()
    cycle_ms = [s_.elapsed_time(e) for s_, e in cycle_events]
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20 if device == "cuda" else None
    gn = gn_step_ms(server, device)
    ts_all = np.asarray(seqs[0].timestamps) - float(seqs[0].timestamps[0])
    kf_valid = server.m.kf_valid.cpu().numpy()
    kf_agent = server.m.kf_agent.cpu().numpy()
    kf_ts = server.m.kf_timestamp.cpu().numpy()
    kf_pose = server.m.kf_pose.cpu().numpy()
    agents, problems = {}, []
    for a in range(n_agents):
        sel = np.nonzero(kf_valid & (kf_agent == a))[0]
        n_ok = sum(st == TrackState.OK for st in states[a])
        acc = {"server_kfs": int(len(sel)), "frames_ok": int(n_ok)}
        if len(sel) >= 8:
            fr = np.asarray([int(np.argmin(np.abs(ts_all - t))) for t in kf_ts[sel]])
            gt = ate.camera_centers(seqs[a].T_cw[fr])
            span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
            acc.update(ate_rmse=float(ate.ate_rmse(ate.camera_centers(kf_pose[sel]), gt)),
                       span=span)
            acc["ate_over_span"] = acc["ate_rmse"] / span
            if not acc["ate_rmse"] < 0.02 * max(span, 1.0):
                problems.append(f"agent{a} server-arena keyframe ATE {acc['ate_rmse']:.4f} m "
                                f">= 0.02 x max(span {span:.3f}, 1)")
        else:
            problems.append(f"agent{a} has {len(sel)} valid server keyframes (< 8)")
        if n_ok < 120:
            problems.append(f"agent{a}: {n_ok} of {F} frames OK (< 120)")
        acc["client"] = dict(clients[a].stats)
        agents[f"agent{a}"] = acc
    st = server.stats
    res = {"agents_n": n_agents, "frames": F, "merges": st["merges"], "loops": st["loops"],
           "gba_runs": st["gba_runs"], "gba_rejected": st.get("gba_rejected", 0),
           "gba_aborted": st.get("gba_aborted", 0), "kf_culled": st.get("kf_culled", 0),
           "mp_culled": st.get("mp_culled", 0),
           "kf_outlier_culled": st.get("kf_outlier_culled", 0),
           "bytes_up": tr.bytes_up, "bytes_down": tr.bytes_down,
           "total_fps_wall": n_agents * F / wall, "wall_s": wall,
           "comm_cycle_ms_p50": float(np.percentile(cycle_ms, 50)),
           "comm_cycle_ms_p90": float(np.percentile(cycle_ms, 90)),
           "comm_cycle_ms_p99": float(np.percentile(cycle_ms, 99)),
           **gn,
           "cascade_ms": stages["verify_candidate_cascade"]["ms"],
           "correct_loop_ms": stages["correct_loop"]["ms"],
           "peak_mem_mib_run": peak_mib, "codec_native": codec.native_available(),
           "server": dict(st), **agents, "launches": launches,
           "server_launches": dict(server_launches), "seed": seed}
    if record is not None:
        res["merge_record"] = record.summary()
    check_launches(launches, problems, k1_expected=n_agents * F, stereo_expected=0)
    if server_launches["hamming_best_two_valid"] <= 0:
        problems.append("the server's cascade launched no fused validity match")
    if server_launches["hamming_best_two_projection"] <= 0:
        problems.append("the server's arena fuse launched no fused projection match")
    if st["merges"] < 1:
        problems.append("no merge")
    if st["gba_runs"] < 1:
        problems.append("no global BA was adopted")
    return finish_phase("collab", res, problems), server


def event_ms(fn) -> tuple:
    """(fn's result, ms between two CUDA events around it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def collab_inertial_config():
    """synthetic_mono at its full width (640x480, 1024 features, 8 levels,
    512 keyframes and 16384 landmarks an agent) with the event gates of
    tests/test_collab_inertial.py (place recognition from 6 keyframes, an
    event every 2), which a 90-frame sequence needs."""
    from multi_orbslam3_tpu_torch import config as cfgm
    return cfgm.synthetic_mono().replace(loop=cfgm.LoopConfig(min_map_kfs=6,
                                                              event_interval_kfs=2))


def collab_inertial_gates(server, clients, seqs, F: int, sent_before_init: int,
                          defer=()) -> tuple:
    """(metrics, problems): tests/test_collab_inertial.py's gates on the
    collab_inertial drill after its first F frames. A gate named in defer
    ("mean_tilt") that fails goes into metrics["deferred"] instead."""
    from multi_orbslam3_tpu_torch.eval import ate
    cl_vi, cl_mono = clients
    seq_vi, seq_mono = seqs
    st = server.stats
    problems = []
    init_f = cl_vi.slam.stats.get("imu_init_frame")
    res = {"imu_initialized": bool(cl_vi.slam.imu_initialized), "imu_init_frame": init_f,
           "sent_before_init": sent_before_init, "server_inertial": server.agents[0].inertial}
    if not cl_vi.slam.imu_initialized:
        problems.append("the VI agent's IMU was never initialized")
    if sent_before_init != 0 or cl_vi.stats["deltas_sent"] <= 0:
        problems.append(f"uplink gate: {sent_before_init} deltas before init, "
                        f"{cl_vi.stats['deltas_sent']} in all")
    if not server.agents[0].inertial:
        problems.append("the server does not know agent 0 is inertial")
    if st["merges"] < 1:
        problems.append("no merge")
    for name, cl in (("VI", cl_vi), ("mono", cl_mono)):
        if cl.stats["corrections_applied"] <= 0:
            problems.append(f"no correction applied on the {name} client")
    if st.get("vi_solves", 0) < 1:
        problems.append("no joint inertial solve ran")
    if init_f is not None:
        i0 = init_f + 2
        est = np.stack([T for _, T in cl_vi.slam.trajectory])[i0:]
        gt = seq_vi.T_cw[i0:F]
        g = ate.camera_centers(gt)
        span = float(np.linalg.norm(g.max(0) - g.min(0)))
        rmse = float(ate.ate_rmse(ate.camera_centers(est), g))
        z = np.array([0.0, 0.0, 1.0])
        tilts = []
        for T_e, T_g in zip(est, gt):
            a, b = T_e[:3, :3] @ z, T_g[:3, :3] @ z
            cosang = np.clip(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)), -1.0, 1.0)
            tilts.append(np.degrees(np.arccos(cosang)))
        tilts = np.asarray(tilts)
        head, tail = float(tilts[:8].mean()), float(tilts[-8:].mean())
        start = max(50, init_f + 4)
        est_m = np.stack([T for _, T in cl_mono.slam.trajectory])[start:]
        rmse_m = float(ate.ate_rmse(ate.camera_centers(est_m),
                                    ate.camera_centers(seq_mono.T_cw[start:F])))
        res.update(vi_ate_rmse=rmse, span=span, tilt_mean_deg=float(tilts.mean()),
                   tilt_head_deg=head, tilt_tail_deg=tail, mono_ate_rmse=rmse_m,
                   mono_from_frame=start)
        if not rmse < 0.12 * max(span, 1.0):
            problems.append(f"VI agent ATE {rmse:.4f} m >= 0.12 x max(span {span:.3f}, 1)")
        if not tilts.mean() < 3.0:
            (res.setdefault("deferred", []) if "mean_tilt" in defer else problems).append(
                f"mean gravity tilt {tilts.mean():.3f} deg >= 3")
        if not tail - head < 1.5:
            problems.append(f"gravity tilt rose {tail - head:.3f} deg (>= 1.5)")
        if not rmse_m < 0.12 * max(span, 1.0):
            problems.append(f"mono agent post-merge ATE {rmse_m:.4f} m >= 0.12 x "
                            f"max(span {span:.3f}, 1)")
    return res, problems


# The JAX package's mean gravity tilt on the full-width drill after 90 frames
# (profiling/jax_collab_inertial_curve.py, JAX on the CPU): printed beside
# the port's; the 3-degree gate is not enforced at this width.
REFERENCE_TILT_FULL_WIDTH_DEG = 6.513


def phase_collab_inertial(device: str = "cuda", n_frames: int = 90, config=None,
                          deterministic: bool = True, on_cycle=None, defer=()) -> tuple:
    """tests/test_collab_inertial.py::test_inertial_agent_collaborates at
    full width: agent 0 a CollabClient(inertial=True), agent 1 a monocular
    CollabClient, a CollabServer(n_agents=2) over InProcessTransport, the
    bundled k=10 L=5 vocabulary; 90 frames an agent at 20 fps (the 2 s
    initialisation and the 4 s refinement both fall inside), a forward
    trajectory with lateral sway (1200 points, seed 31; the mono agent at
    phase 0.3). Each frame: both clients' comm_cycle, then the server's
    with GBA on events; drain_gba at the end. The JAX test's gates: the
    IMU initialized and nothing sent before, the server knows agent 0 is
    inertial, >= 1 merge, corrections applied on both clients, the VI
    agent's ATE after init < 0.12 x max(span, 1), its mean gravity tilt
    < 3 degrees and tail - head < 1.5 degrees, the mono agent's post-merge
    ATE < 0.12 x max(span, 1), >= 1 joint inertial solve; and K1 once a
    client frame. Run under `reproducible` with the server's
    `deterministic` flag. Prints the time of one run_full_inertial_ba on
    the final arena (CUDA events; the arena is restored after it). A gate
    named in defer is printed, not enforced (collab_inertial_gates)."""
    from multi_orbslam3_tpu_torch.collab import CollabClient, CollabServer
    from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.frontend import kernels
    from multi_orbslam3_tpu_torch.pipeline.system import TrackState
    if device == "cuda":
        start_phase()
    c = config or collab_inertial_config()
    F = n_frames
    kw = dict(n_frames=F, n_points=1200, seed=31, trajectory="forward", lateral=0.8,
              sway_freq=0.15)
    seq_vi = synthetic.make_sequence(c, imu=True, **kw)
    seq_mono = synthetic.make_sequence(c, phase=0.3, **kw)
    tr = InProcessTransport()
    cl_vi = CollabClient(c, 0, tr, inertial=True, device=device)
    cl_mono = CollabClient(c, 1, tr, device=device)
    server = CollabServer(c, tr, n_agents=2, device=device)
    server.deterministic = deterministic
    warm_torch_func(device)
    sent_before_init = 0
    cycle_events, states = [], [[], []]
    sync(device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(F):
        states[0].append(cl_vi.process_frame_imu(
            seq_vi.images[i], float(seq_vi.timestamps[i]), seq_vi.imu_acc[i],
            seq_vi.imu_gyro[i], imu_dt(seq_vi, i, c.imu.rate_hz)))
        states[1].append(cl_mono.process_frame(seq_mono.images[i],
                                               float(seq_mono.timestamps[i])))
        if not cl_vi.slam.inertial_ready:
            sent_before_init = cl_vi.stats["deltas_sent"]
        cl_vi.comm_cycle()
        cl_mono.comm_cycle()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        server.comm_cycle(run_gba_on_events=True)
        end.record()
        cycle_events.append((start, end))
        if on_cycle is not None:
            on_cycle(i, server, [cl_vi, cl_mono], [seq_vi, seq_mono])
    server.drain_gba()
    sync(device)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20 if device == "cuda" else None
    cycle_ms = [s_.elapsed_time(e) for s_, e in cycle_events]
    st = server.stats
    # one joint inertial solve on the final arena, timed, then undone
    snap = (server.m, server.kf_imu.copy(), dict(st))
    n_solve, full_ms = event_ms(server.run_full_inertial_ba)
    server.m, server.kf_imu, server.stats = snap[0], snap[1], snap[2]
    st = server.stats
    res = {"frames": F, "merges": st["merges"], "loops": st["loops"],
           "gba_runs": st["gba_runs"], "gba_rejected": st.get("gba_rejected", 0),
           "vi_solves": st.get("vi_solves", 0),
           "vi_pts_truncated": st.get("vi_pts_truncated", 0),
           "kf_ingested": st["kf_ingested"], "bytes_up": tr.bytes_up,
           "bytes_down": tr.bytes_down, "total_fps_wall": 2 * F / wall, "wall_s": wall,
           "comm_cycle_ms_p50": float(np.percentile(cycle_ms, 50)),
           "comm_cycle_ms_p90": float(np.percentile(cycle_ms, 90)),
           "comm_cycle_ms_p99": float(np.percentile(cycle_ms, 99)),
           "full_inertial_ba_ms": full_ms, "full_inertial_ba_solves": n_solve,
           "peak_mem_mib_run": peak_mib,
           "imu_init_scale": cl_vi.slam.stats.get("imu_init_scale"),
           "frames_ok": [sum(x == TrackState.OK for x in s_) for s_ in states],
           "client_vi": dict(cl_vi.stats), "client_mono": dict(cl_mono.stats),
           "server": dict(st), "launches": launches}
    gates, problems = collab_inertial_gates(server, [cl_vi, cl_mono], [seq_vi, seq_mono], F,
                                            sent_before_init, defer)
    res.update(gates)
    if defer:
        res["tilt_mean_deg_reference"] = REFERENCE_TILT_FULL_WIDTH_DEG
    if device == "cuda":
        check_launches(launches, problems, k1_expected=2 * F, stereo_expected=0)
    return finish_phase("collab_inertial", res, problems, server), server


def phase_full_inertial_gba(device: str = "cuda") -> dict:
    """tests/test_full_inertial_gba.py's drill from the port's own modules
    (eval/inertial_drill.py): the 56-keyframe drifted arena. The windowed
    pass (run_inertial_refinement) runs first on a copy; then the joint
    solve (run_full_inertial_ba, 12 iterations) must bring the keyframe
    ATE under 0.6 x the drifted arena's and under 0.8 x the windowed
    pass's. Both solves are timed with CUDA events."""
    from multi_orbslam3_tpu_torch.eval import inertial_drill as drill
    start_phase()
    server, T_gt, _ = drill.build_drifted_arena(drill.drill_config(), device=device)
    ate0 = drill.arena_ate(server, T_gt)
    snap = (server.m, server.kf_imu.copy())
    n_w, windowed_ms = event_ms(server.run_inertial_refinement)
    ate_w = drill.arena_ate(server, T_gt)
    server.m, server.kf_imu = snap
    n_f, full_ms = event_ms(lambda: server.run_full_inertial_ba(iters=12))
    ate_f = drill.arena_ate(server, T_gt)
    res = {"keyframes": len(T_gt), "ate_drifted": ate0, "ate_windowed": ate_w,
           "ate_full": ate_f, "windows": n_w, "windowed_ms": windowed_ms,
           "full_solves": n_f, "full_ms": full_ms}
    problems = []
    if not ate0 > 0.10:
        problems.append(f"the drill produced no drift ({ate0:.4f} m)")
    if n_w <= 0 or n_f != 1:
        problems.append(f"{n_w} windows, {n_f} joint solves")
    if not ate_f < 0.6 * ate0:
        problems.append(f"the joint solve left {ate_f:.4f} m of {ate0:.4f} m (>= 0.6 x)")
    if not ate_f < 0.8 * ate_w:
        problems.append(f"the joint solve ({ate_f:.4f} m) did not beat the windowed pass "
                        f"({ate_w:.4f} m) by 0.8 x")
    return finish_phase("full_inertial_gba", res, problems)


def phase_sharded_gba(server, device: str = "cuda") -> dict:
    """On the collab phase's final arena (m0, left as it was: maps are
    never written in place): the sharded global BA
    over four shards of the card and run_global_ba(force_shard=True) over
    [cuda:0] against the unsharded solve (2 GN steps of 10 CG iterations):
    poses and points within 1e-3 relative, chi2 within 1e-4 relative
    (tests/test_torch_collab_map.py's tolerances); ms per GN step (40 CG
    iterations) for 1 and 4 shards; then dryrun.dryrun_multichip over four
    shards of the card."""
    from multi_orbslam3_tpu_torch.dryrun import dryrun_multichip
    from multi_orbslam3_tpu_torch.opt import global_ba
    start_phase()
    m0 = server.m
    obs, K_obs, fixed, _, pfix = server._assemble_gba()
    obs, K_obs = server._valid_rows(obs, K_obs)
    fixed_d = torch.from_numpy(fixed).to(device)
    pf = None if pfix is None else torch.from_numpy(pfix).to(device)
    args = (m0.kf_pose, fixed_d, m0.mp_pos, m0.mp_valid, obs, K_obs)
    kw = dict(iters=2, cg_iters=10, point_fixed=pf)
    ru = global_ba.global_bundle_adjust(*args, **kw)
    r4 = global_ba.global_bundle_adjust_sharded(*args, devices=[device] * 4, **kw)

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))
    valid_kf = m0.kf_valid
    live = m0.mp_valid
    errs = {"sharded4_pose_rel": rel(r4.poses[valid_kf], ru.poses[valid_kf]),
            "sharded4_point_rel": rel(r4.points[live], ru.points[live]),
            "sharded4_chi2_rel": abs(float(r4.chi2) - float(ru.chi2)) / abs(float(ru.chi2))}
    # the server's entry on one device (the last use of this server: its
    # post-steps cull, fuse and lock the arena; compared where they left
    # the rows)
    server.run_global_ba(iters=2, cg_iters=10, force_shard=True, devices=[device])
    kept_kf = valid_kf & server.m.kf_valid
    kept_mp = live & server.m.mp_valid
    errs["force_shard_pose_rel"] = rel(server.m.kf_pose[kept_kf], ru.poses[kept_kf])
    errs["force_shard_point_rel"] = rel(server.m.mp_pos[kept_mp], ru.points[kept_mp])
    step_ms = {}
    for n in (1, 4):
        def step(n=n):
            return global_ba.global_bundle_adjust_sharded(
                *args, iters=1, cg_iters=40, point_fixed=pf, devices=[device] * n,
                force_shard=True)
        step()
        step_ms[f"gn_step_ms_{n}_shards"] = float(np.median([event_ms(step)[1]
                                                             for _ in range(3)]))
    t0 = time.perf_counter()
    dry = dryrun_multichip([device] * 4)
    res = {**errs, **step_ms, "obs_rows": int(obs.kf.shape[0]), "dryrun": dry,
           "dryrun_s": time.perf_counter() - t0}
    problems = [f"{k} = {v:.3g}" for k, v in errs.items()
                if not v < (1e-4 if k.endswith("chi2_rel") else 1e-3)]
    return finish_phase("sharded_gba", res, problems)


# The JAX package's bench_mini_asl accuracy (BENCH_r05.json, configs.mini_asl;
# an accuracy figure, not a speed one), printed beside the port's.
REFERENCE_MINI_ASL = {"frames": 80, "frames_ok": 78, "ate_rmse": 0.0216}
# The JAX package's bench_vocab_selectivity() at its defaults (30 worlds x 18
# frames, 270 stored keyframes, 270 queries), computed on the CPU with
#   JAX_PLATFORMS=cpu python -c "from multi_orbslam3_tpu.eval import benchmarks as B;
#                                print(B.bench_vocab_selectivity())"
# (224 and 228 top-1 hits). The port's must reach the same top-1 hits within
# one query and margins within 1%.
REFERENCE_VOCAB = {"db_size": 270, "L4_10k": {"top1_recall": 0.83, "margin": 1.072},
                   "L5_100k": {"top1_recall": 0.844, "margin": 1.22}}


def app_process(name: str, *args: str):
    """The port's app `name` as a process started from this checkout's root."""
    import os
    return subprocess.Popen([sys.executable, "-m", f"multi_orbslam3_tpu_torch.apps.{name}", *args],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def run_apps(out_dir: str) -> dict:
    """The port's apps as processes on the card, as tests/test_multiprocess.py
    runs the JAX ones: run_slam (mono, 60 synthetic frames, loop closing on),
    then run_server with two run_client processes over localhost TCP at full
    width (synthetic_mono, 60 frames an agent). Returns each one's last JSON
    line, exit code and seconds; raises if one outlives its time limit."""
    import os
    import socket
    out = {}
    t0 = time.perf_counter()
    slam_dir = os.path.join(out_dir, "run_slam")
    proc = app_process("run_slam", "--sensor", "mono", "--frames", "60", "--out", slam_dir)
    try:
        o, e = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out["run_slam"] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                       "stderr_tail": e[-1500:] if proc.returncode else "",
                       "report": (json.loads(o.strip().splitlines()[-1])
                                  if proc.returncode == 0 else None),
                       "files": sorted(os.listdir(slam_dir)) if os.path.isdir(slam_dir) else []}
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    srv_dir = os.path.join(out_dir, "server")
    t0 = time.perf_counter()
    srv = app_process("run_server", "--port", str(port), "--agents", "2", "--out", srv_dir,
                      "--duration", "600", "--idle-exit", "5")
    clients = []
    try:
        deadline = time.time() + 120
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                if srv.poll() is not None or time.time() > deadline:
                    raise AssertionError("harness: run_server never listened: "
                                         + srv.communicate(timeout=30)[1][-2000:])
                time.sleep(0.5)
        for a in range(2):
            clients.append(app_process(
                "run_client", "--agent", str(a), "--server", f"127.0.0.1:{port}",
                "--out", os.path.join(out_dir, f"client{a}"), "--frames", "60"))
        for a, cl in enumerate(clients):
            o, e = cl.communicate(timeout=500)
            out[f"client{a}"] = {"rc": cl.returncode, "stderr_tail": e[-1500:] if cl.returncode else "",
                                 "stats": (json.loads(o.strip().splitlines()[-1])
                                           if cl.returncode == 0 else None),
                                 "traj": os.path.exists(os.path.join(out_dir, f"client{a}",
                                                                     "KeyFrameTrajectory.txt"))}
        o, e = srv.communicate(timeout=300)
        out["server"] = {"rc": srv.returncode, "stderr_tail": e[-1500:] if srv.returncode else "",
                         "stats": (json.loads(o.strip().splitlines()[-1])
                                   if srv.returncode == 0 else None),
                         "files": sorted(os.listdir(srv_dir)) if os.path.isdir(srv_dir) else [],
                         "seconds": time.perf_counter() - t0}
    finally:
        for p_ in [srv] + clients:
            if p_.poll() is None:
                p_.kill()
                p_.wait()
    return out


def app_problems(apps: dict) -> list:
    """tests/test_multiprocess.py's gates on the processes, and run_slam's:
    >= 50 of 60 frames OK, ATE <= 0.02 x span, its three files."""
    problems = []
    for name in ("run_slam", "client0", "client1", "server"):
        if apps[name]["rc"] != 0:
            problems.append(f"{name} exited {apps[name]['rc']}: {apps[name]['stderr_tail']}")
    rep = apps["run_slam"]["report"]
    if rep is not None:
        if rep.get("frames_ok", 0) < 50:
            problems.append(f"run_slam: {rep.get('frames_ok', 0)} of 60 frames OK (< 50)")
        if not rep.get("ate_rmse", float("inf")) <= 0.02 * rep.get("span", 0.0):
            problems.append(f"run_slam: ATE {rep.get('ate_rmse')} m > 0.02 x span "
                            f"{rep.get('span')} m")
    for f in ("KeyFrameTrajectory.txt", "map.png", "report.json"):
        if f not in apps["run_slam"]["files"]:
            problems.append(f"run_slam wrote no {f}")
    for a in range(2):
        st = apps[f"client{a}"]["stats"]
        if st is not None and not (st["deltas_sent"] > 0 and st["kf_inserted"] > 4):
            problems.append(f"client{a}: {st['deltas_sent']} deltas sent, "
                            f"{st['kf_inserted']} keyframes")
        if not apps[f"client{a}"]["traj"]:
            problems.append(f"client{a} wrote no KeyFrameTrajectory.txt")
    st = apps["server"]["stats"]
    if st is not None and not st["kf_ingested"] > 8:
        problems.append(f"the server ingested {st['kf_ingested']} keyframes (<= 8)")
    for f in ("server_map.npz", "agent0_server_traj.txt", "agent1_server_traj.txt"):
        if f not in apps["server"]["files"]:
            problems.append(f"run_server wrote no {f}")
    return problems


def phase_harness(card: dict) -> dict:
    """The port's harness on the card: eval/benchmarks.py's bench_mini_asl
    (80 frames, seed 41, 752x480, written as an ASL tree by the port's
    writer and read back through EurocSequence, synchronous
    MonoSlam.process_frame), bench_vocab_selectivity (30 worlds x 18
    frames of synthetic_mono, 640x480; 270 keyframes stored, the k10-L4 and
    k10-L5 vocabularies), bench_gba_large (1,024 keyframes, 32,768
    landmarks, 256 features, 4 agents) and bench_kernels (K1 on one
    480x752 level of noise at threshold 20 and K2's matrix at 16,384 x
    1,024 against their plain versions, with the codec study), with the
    launch counts set to 0 before them and read after; then the apps as
    processes (run_apps), whose launches, in other processes, are not in
    the counts. Gates: mini_asl >= 70 of 80 OK and ATE <= 0.02 x span (the
    JAX package's 78/80 and 0.0216 m printed beside); vocabulary top-1 hits
    within one query of 270 and margins within 1% of the JAX package's
    (REFERENCE_VOCAB); the GBA's poses and points finite and both solves
    adopted (a solve whose chi2 rises is rejected); both kernels equal to
    their plain versions; K1 and a fused K2 launched, and K2's matrix;
    the apps' gates (app_problems). Prints the merges of the process run."""
    import shutil
    import tempfile
    from multi_orbslam3_tpu_torch.eval import benchmarks as B
    from multi_orbslam3_tpu_torch.frontend import kernels
    start_phase()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mini = B.bench_mini_asl()
    t_mini = time.perf_counter() - t0
    vocab = B.bench_vocab_selectivity()
    t_vocab = time.perf_counter() - t0 - t_mini
    gba = B.bench_gba_large()
    bk = B.bench_kernels()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    wall = time.perf_counter() - t0
    out_dir = tempfile.mkdtemp(prefix="harness_apps_")
    try:
        apps = run_apps(out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    problems = []
    check_launches(launches, problems)
    if launches["hamming_matrix"] <= 0:
        problems.append("K2's matrix was never launched")
    ok, ate_m, span = mini.get("frames_ok", 0), mini.get("ate_rmse"), mini.get("span")
    if ok < 70:
        problems.append(f"mini_asl: {ok} of 80 frames OK (< 70)")
    if ate_m is None or not ate_m <= 0.02 * span:
        problems.append(f"mini_asl: ATE {ate_m} m > 0.02 x span {span} m")
    for name in ("L4_10k", "L5_100k"):
        hits = round(vocab[name]["top1_recall"] * 270)
        ref_hits = round(REFERENCE_VOCAB[name]["top1_recall"] * 270)
        ref_margin = REFERENCE_VOCAB[name]["margin"]
        if vocab["db_size"] != 270 or abs(hits - ref_hits) > 1:
            problems.append(f"vocab {name}: {hits} of 270 top-1 hits, the JAX package "
                            f"{ref_hits} (db {vocab['db_size']})")
        if not abs(vocab[name]["margin"] - ref_margin) <= 0.01 * ref_margin:
            problems.append(f"vocab {name}: margin {vocab[name]['margin']}, the JAX package "
                            f"{ref_margin} (> 1% apart)")
    if not (gba["finite"] and gba["gba_runs"] == 2 and gba["gba_rejected"] == 0):
        problems.append(f"gba_large: finite {gba['finite']}, {gba['gba_runs']} solves adopted, "
                        f"{gba['gba_rejected']} rejected")
    if not (bk["fast_equal"] and bk["hamming_equal"]):
        problems.append(f"bench_kernels: K1 equal {bk['fast_equal']}, K2 matrix equal "
                        f"{bk['hamming_equal']}")
    problems += app_problems(apps)
    res = {"mini_asl": mini, "mini_asl_reference": REFERENCE_MINI_ASL,
           "mini_asl_s": t_mini, "vocab": vocab, "vocab_reference": REFERENCE_VOCAB,
           "vocab_s": t_vocab, "gba_large": gba,
           "gba_large_peak_mib": gba.get("peak_bytes_in_use", 0) / 2 ** 20,
           "bench_kernels": bk, "benches_wall_s": wall, "launches": launches,
           "apps": apps, "app_merges": (apps["server"]["stats"] or {}).get("merges")}
    return finish_phase("harness", res, problems)


def bench_kernels_k1_bound(card: dict) -> dict:
    """bound_ms of bench_kernels' K1 call: its input (eval/benchmarks.py::
    bench_kernels' one 480x752 level of RandomState(0) noise, threshold
    20) counted as check_k1 counts a level."""
    img = torch.from_numpy(np.random.RandomState(0).uniform(0, 255, (480, 752))
                           .astype(np.float32)).cuda()
    interior, passing = compass_pass_count([img], 20.0)
    return bound(card, 8.0 * img.numel(), fp32_instr=16.0 * interior,
                 minmax_instr=8.0 * interior + 158.0 * passing)


def phase_profiling(device: str = "cuda") -> dict:
    """The port's profilers (multi_orbslam3_tpu_torch/profiling/) on the
    card at the JAX scripts' shapes, each printing one JSON line:
    profile_stages, profile_scatter, profile_covis, then profile_mono with
    its trace pass (frames 60-79) on the mono loop, then profile_ab_u8's
    float32 arm; its uint8 arm is profile_mono's timed pass, the same run.
    Cuts: profile_mono and the float32 arm run without their warm-up
    passes: this phase runs after every other phase in this process, so
    every kernel is built and loaded and the allocator has grown. The
    hand kernels' launches of all five are counted. Fails unless every
    profiler returns, each covis formulation equals the count of its kind
    and the chunked arena matrix the one-chunk one, the one-hot assemblies
    lie within 1e-5 (float32, allclose) and 1e-2 of the largest entry
    (bf16) of index_add's, the grouped and scatter solves of the test_opt
    window agree (poses 1e-4, points 1e-3), K1 was launched once a frame
    and a fused K2 match at least once in profile_mono's timed pass, and
    the traced window's busy share lies in (0, 1]."""
    from multi_orbslam3_tpu_torch.frontend import kernels
    from multi_orbslam3_tpu_torch.profiling import (profile_ab_u8, profile_covis, profile_mono,
                                                    profile_scatter, profile_stages)
    start_phase()
    total = collections.Counter()
    seconds, out, problems = {}, {}, []
    cuts = ["profile_mono: no warm-up pass", "profile_ab_u8 float32 arm: no warm-up pass",
            "profile_ab_u8 uint8 arm: profile_mono's timed pass"]

    def profile(name, fn):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        try:
            out[name] = fn()
        except Exception as e:          # a profiler that fails fails the phase
            traceback.print_exc()
            problems.append(f"{name} raised {type(e).__name__}: {e}")
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        launches = kernels.launch_counts()
        total.update(launches)
        if name in out:
            emit(name, seconds=seconds[name], kernel_launches=launches, **out[name])

    profile("profile_stages", lambda: profile_stages.run(device=device))
    profile("profile_scatter", lambda: profile_scatter.run(device=device))
    profile("profile_covis", lambda: profile_covis.run(device=device))
    profile("profile_mono", lambda: profile_mono.run("mono", trace=True, warmup=False,
                                                     device=device))
    mono = out.get("profile_mono")
    u8_arm = None if mono is None else {
        "u8": True, "fps": mono["fps"], "wall_s": mono["wall_s"], "warmup": False,
        "stats": mono["stats"], "from": "profile_mono's timed pass"}
    profile("profile_ab_u8", lambda: profile_ab_u8.run(warmup=False, u8_arm=u8_arm,
                                                       device=device))

    covis = out.get("profile_covis")
    if covis is not None and not (covis["all_agree"]
                                  and covis["covisibility_matrix_arena"]["chunks_agree"]):
        problems.append(f"covis formulations disagree: {covis['agree']}, arena chunks "
                        f"{covis['covisibility_matrix_arena']['chunks_agree']}")
    scatter = out.get("profile_scatter")
    if scatter is not None:
        ag = scatter["agreement"]
        if not (ag["onehot_f32_allclose"] and ag["onehot_bf16_E_rel"] <= 1e-2
                and ag["onehot_bf16_Hpp_rel"] <= 1e-2):
            problems.append(f"one-hot assemblies off index_add's: {ag}")
        if not (ag["window_poses_max_abs"] <= 1e-4 and ag["window_points_max_abs"] <= 1e-3):
            problems.append(f"grouped and scatter BA disagree on the test_opt window: {ag}")
    busy = None
    if mono is not None:
        check_launches(mono["launches"], problems, k1_expected=mono["frames"])
        busy = mono["trace"].get("busy_share")
        if busy is None or not 0.0 < busy <= 1.0:
            problems.append(f"the mono trace's busy share is {busy}, not in (0, 1]")
    res = {"seconds_by_profiler": seconds, "cuts": cuts,
           "launches": {k: total[k] for k in kernels.launch_counts()},
           "mono_busy_share": busy,
           "mono_top_device_ops": None if mono is None else mono["trace"].get("top_device_ops"),
           "problems": problems}
    return finish_phase("profiling", res, problems)


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
    start_phase()
    for name, cap in timed("kernels_captured", check_k2_captured, card, CAPTURED).items():
        rows[name]["captured"] = cap
    res_off, _ = timed("slice_lc_off", phase_slice, cfg, seq, loop_closing=False)
    res_reloc = timed("relocalize", phase_relocalize, cfg, seq, slam)
    res_atlas = timed("atlas_loop", phase_atlas_loop)
    res_stereo, stereo_slam = timed("stereo", phase_stereo, stereo_cfg, stereo_seq)
    res_wide, wide_slam = timed("stereo_wide", phase_stereo_wide, stereo_seq)
    res_rgbd = timed("rgbd", phase_rgbd, stereo_cfg, stereo_seq)
    res_mi = timed("mono_inertial", phase_mono_inertial)
    res_si = timed("stereo_inertial", phase_stereo_inertial)
    failed = []
    with reproducible():
        res_collab, server = timed("collab", phase_collab, deterministic=True)
        # a failed gate here is raised at the end, after the later phases
        # (which use this phase's server) have run and printed
        t = time.perf_counter()
        try:
            res_ci, vi_server = phase_collab_inertial(defer=("mean_tilt",))
        except PhaseFailed as e:
            failed.append(e)
            res_ci, vi_server = e.res, e.state
        seconds["collab_inertial"] = round(time.perf_counter() - t, 3)
    timed("full_inertial_gba", phase_full_inertial_gba)
    timed("sync_free", phase_sync_free, cfg, slam, seq, stereo_cfg, stereo_slam, stereo_seq,
          server, vi_server, wide_slam)
    timed("sharded_gba", phase_sharded_gba, server)
    t = time.perf_counter()
    try:
        res_h = phase_harness(card)
    except PhaseFailed as e:
        failed.append(e)
        res_h = e.res
    seconds["harness"] = round(time.perf_counter() - t, 3)
    t = time.perf_counter()
    try:
        res_p = phase_profiling()
    except PhaseFailed as e:
        failed.append(e)
        res_p = e.res
    seconds["profiling"] = round(time.perf_counter() - t, 3)
    emit("total", seconds_by_phase=seconds,
         total_s=round(time.perf_counter() - T_START, 3))
    paths = (res, res_off, res_reloc, res_atlas, res_stereo, res_wide, res_rgbd, res_mi,
             res_si, res_collab, res_ci, res_h, res_p)
    # the harness's kernel micro-bench (eval/benchmarks.py::bench_kernels,
    # the JAX package's shapes): its mean ms a call, beside each row
    bk = res_h["bench_kernels"]
    bench_rows = {"fast_score_nms_levels": {
        "shape": [480, 752], "inputs": "noise, one level, threshold 20",
        "kernel_ms": bk["fast_kernel_ms"], "plain_ms": bk["fast_plain_ms"],
        "equal": bk["fast_equal"], **bench_kernels_k1_bound(card)},
        "hamming_matrix": {
        "shape": [16384, 1024], "inputs": "random words",
        "kernel_ms": bk["hamming_kernel_ms"], "plain_ms": bk["hamming_plain_ms"],
        "equal": bk["hamming_equal"],
        **bound(card, 32.0 * (16384 + 1024) + 4.0 * 16384 * 1024,
                hamming_pairs=16384.0 * 1024)}}
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
                "bound_by": r["bound_by"], "limit": r["limit"],
                "library_ms": r.get("library_ms"),
                **{k: r[k] for k in ("popc_bound_ms", "library", "library_prep_ms",
                                     "call_device_ms", "device_launches") if k in r},
                "card": card["smi"],
                **{key: [{k: a[k] for k in (
                    "shape", "inputs", "launches_per_call", "device_ms", "call_ms",
                    "call_device_ms", "device_launches", "plain_ms", "bound_ms",
                    "bound_by", "limit", "popc_bound_ms") if k in a}
                    for a in r[key]]
                   for key in ("arena_shapes", "captured", "grouped", "chunked")
                   if key in r},
                **({"bench_kernels": bench_rows[vname]} if vname in bench_rows else {})})
        head = next(v for v in variants if v["name"] == k["headline"])
        entries.append({**head, "name": name, "source": k["source"],
                        "measured_as": k["headline"],
                        "launches": sum(v["launches"] for v in variants),
                        "variants": variants})
    print(card["smi"], flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    if failed:
        raise failed[0]
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
