"""Run one cell of BENCHMARK.json once, in this process:

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the port's kernels built or loaded, the systems and their
vocabulary, the cell's frames rendered on the card from the seed, a warm-up
that drives every path the window uses), then a closed-loop window of
`--seconds`, then the comparison with the plain reference. Earlier stdout
lines give the set-up's parts and the window's work; the last is one JSON
object. With --trace 1 the line carries the per-layer metrics, read from
host spans over the window and from a torch.profiler trace of a fixed
number of frames run after the window closes; the port's own tracer
(multi_orbslam3_tpu_torch/utils/timing.py) records its spans over the
window and its spans and host syncs over the traced frames, and two lines
come before the result: `{"spans": ...}`, the traced frames' device idle
ms, launches and host syncs by innermost program span
(slambench/harness/program_spans.tables; null without traced frames), and
`{"span_table": ...}`, the tracer's summary() of the window. With
--trace 0 the tracer stays off. The numbers compared with the reference
close stderr.

The run refuses, printing no result, where there is no CUDA device (or
fewer than the cell asks for), where the port is not beside this package,
and where the JAX package or JAX itself is loaded once the window has
closed."""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()     # process start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "multi_orbslam3_tpu")


class Ctx:
    """What the metric readers of slambench/metrics read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def read_metric(name: str, ctx: Ctx):
    from slambench.harness import files
    return files.load("metrics", name).read(ctx)


def card_info(torch) -> dict:
    out = {"sm_count": torch.cuda.get_device_properties(0).multi_processor_count}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,name,power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    clock, name, power = (x.strip() for x in smi.split(","))
    out.update(max_sm_clock_hz=float(clock) * 1e6, smi_name=name, power_limit_w=power)
    return out


def host_probe_ms(device, reps: int = 3) -> float:
    """The host's pace: the least time, in ms, of a fixed loop of 5,000
    in-place launches of one small tensor operation on `device` (the
    Python, dispatcher and driver work that paces the frame loop), with the
    garbage collector held off; timed before and after the window."""
    import gc

    import torch
    x = torch.zeros(4, device=device)
    best = float("inf")
    gc.disable()
    try:
        for _ in range(reps):
            t = time.perf_counter()
            for _ in range(5000):
                x.add_(1.0)
            if x.is_cuda:
                torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t)
    finally:
        gc.enable()
    return best * 1e3


def delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        b = before.get(k)
        if isinstance(v, list):
            out[k] = [x - (b[i] if b else 0) for i, x in enumerate(v)]
        else:
            out[k] = v - (b or 0)
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, device_name: str = "cuda",
        bench_path=None, root=None, fault=None, control=False, emit=print) -> dict:
    """One run; returns the result line's object. device_name "cpu" and
    `fault` serve the benchmark's own tests only (no chip, a broken path);
    control=True adds "control": the compared numbers of the control (the
    reference in TF32 in the port's place) on the same window's calls."""
    import torch

    from slambench import drivers
    from slambench.harness import cell as cellm
    from slambench.harness import check, program_spans, traffic
    from slambench.harness.capture import Capture
    from slambench.harness.spans import Spans
    from slambench.harness.trace import TraceWindow

    c = cellm.load_cell(workload, bench_path, root)
    conf, tfc = c.config, c.traffic
    on_card = device_name == "cuda"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < c.chips):
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"slambench: {workload} needs {c.chips} CUDA device(s); torch sees {seen}")
    device = torch.device(device_name)
    if on_card:
        torch.zeros(1, device=device)          # the CUDA context
    setup = {"process_to_cuda_s": time.perf_counter() - T_PROCESS}

    t = time.perf_counter()
    import multi_orbslam3_tpu_torch  # noqa: F401
    from multi_orbslam3_tpu_torch.frontend import kernels
    cfg = cellm.system_config(conf)
    setup["import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if on_card:
        kernels._lib()            # nvcc into the checkout's _build/ on a first run
    setup["extension_s"] = time.perf_counter() - t

    spans = Spans()
    capture = Capture(seed, conf.get("capture", {}))
    program = program_spans.Recorder(program_spans.tracer() if trace else None)
    t = time.perf_counter()
    frames = traffic.generate(tfc, cfg.camera, seed, device, where=c.roots)
    if on_card:
        torch.cuda.synchronize()
    setup["render_s"] = time.perf_counter() - t
    t = time.perf_counter()
    drv = drivers.make_driver(conf, cfg, frames, device, spans, capture, c.roots)
    setup["systems_s"] = time.perf_counter() - t      # vocabulary and map arenas
    with spans:
        if fault is not None:
            fault(spans)          # under the captures, as a fault of the port would be
        drv.install()
        t = time.perf_counter()
        setup["warmup_rounds"] = int(tfc["warmup"]["rounds"])
        drv.warmup(setup["warmup_rounds"])
        if on_card:
            torch.cuda.synchronize()
        setup["warmup_s"] = time.perf_counter() - t
        setup_s = time.perf_counter() - T_PROCESS
        setup["setup_s"] = setup_s
        emit(json.dumps({"setup": setup}))
        probe_ms = [host_probe_ms(device)]

        # the window; a traced run's window leaves the traced frames for
        # after it, where a fast host would otherwise spend them
        trace_rounds = int(tfc["trace"]["rounds"])
        traced_run = trace and on_card
        work0 = drv.work()
        with program.stretch("window", syncs=False):
            spans.on = capture.on = True
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames_done = 0
            while time.perf_counter() - t0 < seconds:
                n = drv.round()
                if n == 0:
                    break
                frames_done += n
                if traced_run and drv.frames_left() <= trace_rounds:
                    break
            if on_card:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            spans.on = capture.on = False
        probe_ms.append(host_probe_ms(device))
        work = delta(drv.work(), work0)
        work["frames_left"] = drv.frames_left()
        work.update(drv.map_size())
        emit(json.dumps({"work": work, "window_s": window_s, "host_probe_ms": probe_ms}))

        # the traced frames: after the window, so that neither the
        # profiler's overhead nor the reading of its events falls in it
        tw, trace_frames = None, 0
        if traced_run and drv.frames_left() >= trace_rounds:
            tw = TraceWindow()
            drv.tcap.on = spans.on = True
            with spans.aside(), tw, program.stretch("traced", syncs=True):
                for _ in range(trace_rounds):
                    trace_frames += drv.round()
            drv.tcap.on = spans.on = False
        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    # the per-layer reading, then the program's state is freed and the
    # reference runs
    card = card_info(torch) if (trace and on_card) else None
    traced = program.records.get("traced")
    ctx = Ctx(spans=spans, window_s=window_s, frames=frames_done, work=work,
              setup_s=setup_s, trace=tw, trace_frames=trace_frames, tcap=drv.tcap,
              card=card, program=program.records.get("window"), program_traced=traced)
    wanted = c.per_layer if trace else c.end_to_end
    metrics = {}
    for m in wanted:
        v = read_metric(m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    breakdown = None
    if tw is not None:
        breakdown = {"device_ops": tw.top_ops(), "idle_gaps": tw.idle_gaps(spans.aside_records)}
    if trace:
        emit(json.dumps({"spans": program_spans.tables(tw, traced)
                         if tw is not None and traced is not None else None}))
        emit(json.dumps({"span_table": program.summaries.get("window")}))
    checked, compared = drv.checked, tuple(drv.compared)
    drv.release()
    del drv, frames, ctx
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers = check.run_checks(capture, cfg, device, compared, c.roots)
    correct, rows = check.verdict(numbers, c.check["numbers"])
    print(f"slambench: the reference's comparison took {time.perf_counter() - t:.2f} s",
          file=sys.stderr)
    control_numbers = (check.run_checks(capture, cfg, device, compared, c.roots, control=True)
                       if control else None)
    correct = correct and capture.seen(checked) > 0 and frames_done > 0

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"slambench: the JAX side is loaded in this process: {', '.join(bad)}")

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": c.chips, "memory_peak_bytes": int(memory_peak)}
    if trace and tw is not None:
        dev["busy_s"] = tw.busy_s()
        dev["window_s"] = tw.wall_s
    result = {"correct": bool(correct), "attempted": int(frames_done),
              "failed": int(work.get("frames_lost", 0)), "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control_numbers is not None:
        result["control"] = control_numbers
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        import multi_orbslam3_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"slambench: the port (multi_orbslam3_tpu_torch) is not importable here: {e}",
              file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    result = run(a.workload, a.seed, a.seconds, bool(a.trace))
    for name, row in result["checks"].items():
        print(f"check {name} = {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
