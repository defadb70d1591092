"""The readers of the port's own spans (slambench/harness/program_spans.py)
on the CPU: the tiny cell's `--trace 1` run (slambench.run, which switches
the port's tracer on) gives every span-reading metric of the window, and
the result line keeps its keys; on planted records and a planted trace, device
events are attributed to the span that launched them and idle time to the
span it falls in; a context without the tracer's records reads None."""

import collections
import json

import pytest
import torch

from slambench import run
from slambench.harness import program_spans
from slambench.tests.conftest import DATA

SEED = 2 ** 31 + 11
WINDOW_METRICS = ["extract_ms_per_frame", "projection_match_ms_per_frame",
                  "pose_opt_ms_per_frame", "local_ba_ms_per_keyframe",
                  "host_wait_ms_per_frame", "pose_latency_p95_ms"]
SPAN_METRICS = WINDOW_METRICS + ["host_syncs_per_frame"]


@pytest.fixture(scope="module")
def traced_run():
    lines = []
    res = run.run("tiny_stereo.revisit", SEED, 60.0, trace=True, device_name="cpu",
                  bench_path=DATA / "BENCHMARK.json", root=DATA, emit=lines.append)
    return res, [json.loads(line) for line in lines]


def test_the_tiny_cell_reads_every_window_span_metric(traced_run):
    res, lines = traced_run
    assert res["correct"], res["checks"]
    for name in WINDOW_METRICS:
        assert res["metrics"][name]["value"] is not None, name
        assert res["metrics"][name]["value"] >= 0.0, name
    m = res["metrics"]
    assert m["pose_latency_p95_ms"]["value"] > 0 and m["extract_ms_per_frame"]["value"] > 0
    # no traced frames on the CPU: no syncs counted, no device tables
    assert [next(iter(line)) for line in lines] == ["setup", "work", "spans", "span_table"]
    assert "host_syncs_per_frame" not in m and lines[2]["spans"] is None
    table = lines[3]["span_table"]
    assert table["frame"]["count"] == res["attempted"]
    assert table["step.match"]["count"] == table["step.pose_opt"]["count"]
    # the tracer is off again, and the result line keeps slambench.run's keys
    assert not program_spans.tracer().on
    assert list(res)[:6] == ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_the_step_adds_up_to_its_parts_and_self_time(traced_run):
    table = traced_run[1][3]["span_table"]
    parts = sum(table[n]["total_s"] for n in ("step.extract", "step.stereo", "step.match",
                                               "step.pose_opt"))
    # each total rounded to 0.1 ms
    assert parts + table["step:self"]["total_s"] == pytest.approx(table["step"]["total_s"],
                                                                   abs=3e-4)


def test_a_context_without_the_tracers_records_reads_none():
    ctx = run.Ctx(trace=None, trace_frames=0)
    for name in SPAN_METRICS + ["step_launches_per_frame"]:
        assert run.read_metric(name, ctx) is None, name


class _Span:
    def __init__(self, name, t0, t1, parent, frame=0):
        self.name, self.t0, self.t1, self.parent, self.frame = name, t0, t1, parent, frame


class _Event:
    def __init__(self, name, device, kind, start, dur, corr):
        self._v = (name, device, kind, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def activity_type(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


def _planted():
    """Host clock 0-100: frame [0, 100] > step [10, 60] > match [20, 40];
    frame > finalize [60, 90]. Device clock = host + 1000. Three kernels
    launched at 15 (step), 25 (match), 70 (finalize), one memcpy launched
    at 95 (frame), the marker; device busy [1030, 1050] and [1075, 1080].
    The traced frames run from host 5 to 100."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [_Event("cudaLaunchKernel", cpu, "cuda_runtime", t + 1000, 2, c)
              for t, c in ((15, 1), (25, 2), (70, 3), (95, 4), (1, 5))]
    events += [_Event("k_a", cuda, "kernel", 1030, 10, 1), _Event("k_b", cuda, "kernel", 1040, 10, 2),
               _Event("k_c", cuda, "kernel", 1075, 5, 3),
               _Event("Memcpy DtoH", cuda, "gpu_memcpy", 1096, 1, 4),
               _Event("spin_kernel", cuda, "kernel", 1002, 1, 5)]
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: events})()
    trace = type("T", (), {})()
    trace._prof, trace.offset_ns, trace.t0_ns, trace.t1_ns = prof, 1000, 5, 100
    trace.events = [(e.name(), e.start_ns(), e.duration_ns()) for e in events
                    if e.device_type() == cuda and e.name() != "spin_kernel"]
    rec = program_spans.Records([_Span("frame", 0, 100, -1), _Span("step", 10, 60, 0),
                                 _Span("step.match", 20, 40, 1), _Span("finalize", 60, 90, 0)],
                                [(2, "host_syncs", 1), (3, "host_syncs", 2)])
    return trace, rec


def test_launches_and_idle_time_go_to_the_innermost_span_that_launched_them():
    trace, rec = _planted()
    launched = program_spans.launch_host_ns(trace)
    assert [(n, h) for n, _, _, h in launched] == [("k_a", 15), ("k_b", 25), ("k_c", 70),
                                                    ("Memcpy DtoH", 95)]
    assert [rec.name_at(t) for t in (0, 10, 20, 39, 40, 59, 60, 90, 100)] == \
        ["frame", "step", "step.match", "step.match", "step", "step", "finalize", "frame", "-"]
    t = program_spans.tables(trace, rec)
    assert t["frames"] == 1
    assert t["launches"] == {"step": 1, "step.match": 1, "finalize": 1, "frame": 1}
    assert t["host_syncs"] == {"step.match": 1, "finalize": 2}
    # idle on the host clock: [5, 30], [50, 75], [80, 96], [97, 100]
    idle = collections.Counter({k: round(v * 1e6) for k, v in t["idle_ms"].items()})
    assert idle == {"frame": 5 + 6 + 3, "step": 10 + 10, "step.match": 10,
                    "finalize": 15 + 10}
    ctx = run.Ctx(trace=trace, trace_frames=1, spans=type("S", (), {
        "aside_records": [("frame", 0, 100, 0, None), ("fused_step", 10, 60, 1, None)]})())
    assert run.read_metric("step_launches_per_frame", ctx) == 2.0
