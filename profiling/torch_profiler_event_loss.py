"""Does torch.profiler read every device launch of a traced call? On one
GPU:

    python3 profiling/torch_profiler_event_loss.py [--busy-s 60]

Counts the device events of three calls of known size (1, 30 and 300
chained adds on an (8, 128) tensor) four ways: the port's
profiling.common.launches (CUDA activity), a CPU + CUDA trace read from
kineto's events, a CUDA trace read through ``prof.events()``, and three
calls in one trace divided by three. It counts once in a fresh process,
again after 200 CUDA-only and 200 CPU + CUDA profiler sessions, again after
``--busy-s`` seconds of launches with no profiler running, and again after
the switches chip_smoke.py flips (deterministic algorithms, sync debug
mode) and a CUDA graph capture. Prints one JSON line each time, then the
card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--busy-s", type=float, default=60.0)
    args = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile
    from multi_orbslam3_tpu_torch.profiling import common

    dev = torch.device("cuda")
    x = torch.zeros(8, 128, device=dev)

    def work(n):
        def f():
            y = x
            for _ in range(n):
                y = y + 1
            return y
        return f

    calls = {"w1": work(1), "w30": work(30), "w300": work(300)}

    def traced(fn, activities, reps=1):
        fn()
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return prof

    cuda, cpu = [ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ways = {
        "launches": lambda fn: common.launches(fn, dev),
        "cpu_cuda": lambda fn: len(common._device_events(traced(fn, cpu))),
        "events_api": lambda fn: sum(1 for e in traced(fn, cuda).events()
                                     if e.device_type == torch.autograd.DeviceType.CUDA),
        "three_calls": lambda fn: len(common._device_events(traced(fn, cuda, 3))) / 3}
    t0 = time.perf_counter()

    def measure(label):
        out = {"label": label, "t_s": time.perf_counter() - t0}
        for name, fn in calls.items():
            out[name] = {way: count(fn) for way, count in ways.items()}
        print(json.dumps(out), flush=True)

    measure("fresh")
    for _ in range(200):
        traced(calls["w300"], cuda)
    measure("after 200 CUDA-only sessions")
    for _ in range(200):
        traced(calls["w300"], cpu).key_averages()
    measure("after 200 CPU + CUDA sessions with key_averages")
    t = time.perf_counter()
    while time.perf_counter() - t < args.busy_s:
        calls["w300"]()
    torch.cuda.synchronize()
    measure(f"after {args.busy_s:g} s of launches without the profiler")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.cuda.set_sync_debug_mode("error")
    calls["w30"]()
    torch.cuda.set_sync_debug_mode(0)
    torch.use_deterministic_algorithms(False)
    measure("after deterministic algorithms and sync debug mode")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls["w30"]()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        calls["w30"]()
    graph.replay()
    torch.cuda.synchronize()
    measure("after a CUDA graph capture")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
