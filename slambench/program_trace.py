"""One traced run of a cell with the port's own tracer on
(multi_orbslam3_tpu_torch/utils/timing.py):

    python3 -m slambench.program_trace --workload <cell> --seed <n> --seconds <s>

The run is slambench.run's `--trace 1` run. The tracer is switched on for
the window (spans only, so that counting syncs costs the window nothing)
and again for the traced frames (spans and host syncs), and the two sets of
records are kept apart. Before the result line it prints `{"spans": ...}`:
over the traced frames, device idle ms, device launches and host syncs by
innermost program span (slambench/harness/program_spans.tables); and
`{"span_table": ...}`: the tracer's summary() over the window (per span
name count, total and percentiles, and its self time). The
result line's metrics add the readers of SPAN_METRICS, which read the
tracer's records and are not in BENCHMARK.json. The benchmark's own runs do
not run it. A port without a tracer that can be switched on exits 2."""

from __future__ import annotations

import argparse
import json
import sys

# the readers of slambench/metrics that read the port's tracer: unit
SPAN_METRICS = {"extract_ms_per_frame": "ms", "projection_match_ms_per_frame": "ms",
                "pose_opt_ms_per_frame": "ms", "local_ba_ms_per_keyframe": "ms",
                "host_wait_ms_per_frame": "ms", "pose_latency_p95_ms": "ms",
                "host_syncs_per_frame": "syncs"}


def run(workload: str, seed: int, seconds: float, device_name: str = "cuda",
        bench_path=None, root=None, emit=print) -> dict:
    """slambench.run.run(trace=True) with the tracer on; returns the result
    line's object with the span metrics added and "spans" (the traced
    frames' tables, None without traced frames) and "span_table" beside it."""
    from slambench import run as runm
    from slambench.harness import program_spans
    from slambench.harness import trace as tracem

    tracer = program_spans.tracer()
    if tracer is None:
        raise SystemExit(2)
    got = {}

    def hook(line: str) -> None:
        head = next(iter(json.loads(line)))
        if head == "setup":             # the window starts next
            tracer.start(syncs=False)
        elif head == "work":            # the window has ended
            tracer.stop()
            got["window"] = program_spans.Records.take(tracer)
            got["span_table"] = tracer.summary()
        emit(line)

    base = tracem.TraceWindow

    class TracedFrames(base):
        def __enter__(self):
            super().__enter__()
            got["trace"] = self
            tracer.start(syncs=True)
            return self

        def __exit__(self, *exc):
            tracer.stop()
            got["traced"] = program_spans.Records.take(tracer)
            return super().__exit__(*exc)

    tracem.TraceWindow = TracedFrames
    try:
        result = runm.run(workload, seed, seconds, True, device_name=device_name,
                          bench_path=bench_path, root=root, emit=hook)
    finally:
        tracem.TraceWindow = base
        tracer.stop()
    traced = got.get("traced")
    ctx = runm.Ctx(program=got.get("window"), program_traced=traced,
                   trace=got.get("trace"), trace_frames=traced.n("frame") if traced else 0)
    for name, unit in SPAN_METRICS.items():
        v = runm.read_metric(name, ctx)
        if v is not None:
            result["metrics"][name] = {"value": float(v), "unit": unit}
    result["spans"] = (program_spans.tables(got["trace"], traced)
                       if traced is not None and "trace" in got else None)
    result["span_table"] = got.get("span_table")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    result = run(a.workload, a.seed, a.seconds)
    print(json.dumps({"spans": result.pop("spans")}))
    print(json.dumps({"span_table": result.pop("span_table")}))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
