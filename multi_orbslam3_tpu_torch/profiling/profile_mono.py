"""Wall-time buckets of the mono loop, and a device trace of a window of
frames of any loop (counterpart of the JAX package's
profiling/profile_mono.py).

    python -m multi_orbslam3_tpu_torch.profiling.profile_mono [--trace]
        [--config {mono,stereo,mono_inertial,collab_2agent}] [--device cpu]

mono (the default): bench_mono's sequence (752x480, 120 frames, 1,500
points, seed 5, forward) through MonoSlam.process_frame with loop closing
on: a warm-up pass, then a timed pass on a fresh system with the port's
tracer on (utils/timing.py), whose spans fill five wall-time buckets
(BUCKETS: the step's dispatch, the host's decision for the frame, the
mapping chain's dispatch, adoptions, forced or not, and loop closing; the
tracer is off again when the pass ends, also on an exception). Reports fps,
frame ms percentiles, the buckets sorted by total, stats and the hand
kernels' launches in the timed pass. With --trace, a third pass on a fresh
system traces frames 60-79 with common.trace_window, so the profiler's
cost touches neither the timed pass nor the other frames.

The other configurations trace one pass of their loop on the sequences of
eval/benchmarks.py: stereo (bench_stereo, process_frame_stereo_pipelined,
frames 50-69), mono_inertial (bench_mono_inertial, process_frame_imu,
frames 60-79, after the inertial initialisation at about frame 44) and
collab_2agent (bench_collab's two agents and server, cycles 80-99). The
wall buckets are the mono loop's only, as in the JAX script. Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Optional, Tuple

import numpy as np
import torch

from multi_orbslam3_tpu_torch import devices
from multi_orbslam3_tpu_torch.profiling import common
from multi_orbslam3_tpu_torch.utils.timing import GLOBAL_TIMER

CONFIGS = ("mono", "stereo", "mono_inertial", "collab_2agent")
# frames (server cycles for collab) traced: [start, stop)
TRACE_WINDOW = {"mono": (60, 80), "stereo": (50, 70), "mono_inertial": (60, 80),
                "collab_2agent": (80, 100)}


# the port's tracer spans (utils/timing.py) behind the mono loop's buckets
BUCKETS = {"step": "extract_and_track_dispatch", "finalize": "track_decide_total",
           "mapping": "dispatch_mapping", "adopt": "adopt_pending",
           "place_recognition": "loop_close"}


@contextlib.contextmanager
def wall_buckets():
    """Record the port's tracer over the block; yields {bucket: [seconds,
    ...]}, filled from the spans of BUCKETS once the block ends. An
    adoption with a "wait.mapping" child (a forced one) goes to
    "adopt_pending_force". The tracer is off again when the block ends,
    however it ends."""
    buckets = {}
    with GLOBAL_TIMER.recording(syncs=False) as tracer:
        yield buckets
    forced = {s.parent for s in tracer.spans if s.name == "wait.mapping"}
    for i, s in enumerate(tracer.spans):
        name = BUCKETS.get(s.name)
        if name is None:
            continue
        if i in forced:
            name = "adopt_pending_force"
        buckets.setdefault(name, []).append((s.t1 - s.t0) / 1e9)


def _loop(name: str, c, n_frames: Optional[int], device: torch.device):
    """(frames, make) for a configuration: make() builds a fresh system and
    returns (step(i), finish(), system). The sequences are eval/benchmarks.py's."""
    from multi_orbslam3_tpu_torch import config as cfg
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.eval import benchmarks as B
    if name == "mono":
        from multi_orbslam3_tpu_torch.pipeline.system import MonoSlam
        c = c if c is not None else B._euroc_scale_config()
        seq = synthetic.make_sequence(c, n_frames=n_frames or 120, n_points=1500, seed=5,
                                      trajectory="forward")

        def make():
            slam = MonoSlam(c, enable_loop_closing=True, device=device)
            return (lambda i: slam.process_frame(seq.images[i], float(seq.timestamps[i])),
                    lambda: None, slam)
    elif name == "stereo":
        from multi_orbslam3_tpu_torch.pipeline.stereo_system import StereoSlam
        c = c if c is not None else B._euroc_scale_config(baseline=0.11)
        seq = synthetic.make_sequence(c, n_frames=n_frames or 80, n_points=1200, seed=9,
                                      trajectory="forward")

        def make():
            slam = StereoSlam(c, enable_loop_closing=True, device=device)
            return (lambda i: slam.process_frame_stereo_pipelined(
                seq.images[i], seq.images_right[i], float(seq.timestamps[i])),
                slam.finish, slam)
    elif name == "mono_inertial":
        from multi_orbslam3_tpu_torch.pipeline.inertial_system import MonoInertialSlam
        if c is None:
            c = B._euroc_scale_config().replace(imu=cfg.IMUConfig(T_bc=B.EUROC_T_BC))
        seq = synthetic.make_sequence(c, n_frames=n_frames or 90, n_points=1200, seed=7,
                                      trajectory="forward", imu=True, lateral=0.8,
                                      sway_freq=0.15)
        rate = c.imu.rate_hz

        def make():
            slam = MonoInertialSlam(c, enable_loop_closing=True, device=device)

            def step(i):
                dt = np.diff(seq.imu_t[i], prepend=seq.imu_t[i][0] - 1.0 / rate)
                dt = np.where(seq.imu_t[i] > 0, np.maximum(dt, 0.0), 0.0)
                slam.process_frame_imu(seq.images[i], float(seq.timestamps[i]),
                                       seq.imu_acc[i], seq.imu_gyro[i], dt)
            return step, lambda: None, slam
    elif name == "collab_2agent":
        from multi_orbslam3_tpu_torch.collab import CollabClient, CollabServer
        from multi_orbslam3_tpu_torch.collab.transport import InProcessTransport
        c = c if c is not None else cfg.synthetic_mono()
        n = n_frames or 150
        seqs = [synthetic.make_sequence(c, n_frames=n, n_points=1200, seed=31,
                                        trajectory="circle", phase=1.1 + 0.55 * a,
                                        arc=2.3 * np.pi) for a in range(2)]

        def make():
            tr = InProcessTransport()
            clients = [CollabClient(c, a, tr, device=device) for a in range(2)]
            server = CollabServer(c, tr, n_agents=2, device=device)

            def step(i):
                for a, cl in enumerate(clients):
                    cl.process_frame(seqs[a].images[i], float(seqs[a].timestamps[i]))
                    cl.comm_cycle()
                server.comm_cycle()
            return step, server.drain_gba, server
        return n, make
    else:
        raise ValueError(f"unknown configuration {name!r}; one of {CONFIGS}")
    return len(seq.images), make


def _drive(F: int, make, device, window: Optional[Tuple[int, int]] = None):
    """One pass over F frames on a fresh system: (frame seconds, wall s,
    system, trace or None). The trace covers frames [window)."""
    step, finish, system = make()
    lo, hi = window if window is not None else (F, F)
    frame_s, trace = [], None

    def timed(frames):
        for i in frames:
            tf = time.perf_counter()
            step(i)
            frame_s.append(time.perf_counter() - tf)

    common.sync(device)
    t0 = time.perf_counter()
    timed(range(lo))
    if window is not None:
        with common.trace_window(device, hi - lo) as trace:
            for i in range(lo, hi):
                step(i)
    timed(range(hi, F))
    finish()
    common.sync(device)
    return np.asarray(frame_s), time.perf_counter() - t0, system, trace


def run(config: str = "mono", cfg=None, n_frames: Optional[int] = None,
        trace: bool = False, warmup: bool = True,
        window: Optional[Tuple[int, int]] = None, device=None) -> dict:
    """The profile of one configuration (see the module docstring). cfg
    None is the benchmark's camera and capacities; n_frames None its
    length; window None the frames of TRACE_WINDOW; warmup False drops the
    mono loop's warm-up pass."""
    device = devices.resolve(device, "profile_mono")
    F, make = _loop(config, cfg, n_frames, device)
    window = window or TRACE_WINDOW[config]
    out = {"profile": "mono", "config": config, "device": common.card_name(device),
           "frames": F}
    if config != "mono":
        _, wall, system, tr = _drive(F, make, device, window)
        out.update(trace_window=list(window), trace=tr,
                   stats=dict(system.stats), wall_s=wall)
        return out
    from multi_orbslam3_tpu_torch.frontend import kernels
    if warmup:
        _drive(F, make, device)
    before = kernels.launch_counts()
    with wall_buckets() as buckets:
        frame_s, wall, slam, _ = _drive(F, make, device)
    launches = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    ft = frame_s * 1e3
    out.update(
        fps=F / wall, wall_s=wall, warmup=warmup,
        frame_ms={"p50": float(np.percentile(ft, 50)), "p90": float(np.percentile(ft, 90)),
                  "p99": float(np.percentile(ft, 99)), "max": float(ft.max()),
                  "mean": float(ft.mean())},
        buckets=[{"name": k, "n": len(v), "sum_s": float(np.sum(v)),
                  "mean_ms": float(np.mean(v) * 1e3), "max_ms": float(np.max(v) * 1e3),
                  "share": float(np.sum(v) / wall)}
                 for k, v in sorted(buckets.items(), key=lambda kv: -sum(kv[1]))],
        stats=dict(slam.stats), launches=launches)
    if trace:
        _, wall_t, _, tr = _drive(F, make, device, window)
        out.update(trace_window=list(window), trace=tr, trace_pass_wall_s=wall_t,
                   # the same frames of the timed pass, to set the trace's cost against
                   timed_pass_window_ms=float(ft[window[0]:window[1]].sum()))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=CONFIGS, default="mono")
    ap.add_argument("--trace", action="store_true",
                    help="mono: a third pass traced over frames 60-79")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    a = ap.parse_args(argv)
    out = run(a.config, trace=a.trace, device=a.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
