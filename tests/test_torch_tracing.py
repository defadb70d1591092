"""The port's tracer (multi_orbslam3_tpu_torch/utils/timing.py) on the CPU:
off it records nothing; on a planted tree of spans its parents, frame ids,
self times, counters and summary come out right; a tiny stereo sequence
gives the same trajectory and stats with the tracer on and off, and its
pipelined loop finalizes frame i inside the call that receives frame i+1;
the host-sync counter files the sync debug mode's warnings under the
innermost span and puts the warning state back."""

import json
import warnings

import numpy as np
import pytest
import torch

from multi_orbslam3_tpu.utils import timing as jtiming
from multi_orbslam3_tpu_torch import config as tcfg
from multi_orbslam3_tpu_torch.dataio import synthetic
from multi_orbslam3_tpu_torch.pipeline.stereo_system import StereoSlam
from multi_orbslam3_tpu_torch.utils import timing
from multi_orbslam3_tpu_torch.utils.timing import GLOBAL_TIMER

torch.set_num_threads(2)

N_FRAMES = 16


def stereo_config():
    c = tcfg.synthetic_mono(width=320, height=240)
    return c.replace(
        sensor="stereo",
        camera=tcfg.CameraConfig(width=320, height=240, fx=400.0, fy=400.0,
                                 cx=160.0, cy=120.0, baseline=0.2),
        orb=tcfg.ORBConfig(n_features=256, n_levels=4),
        map=tcfg.MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                           max_obs_per_kf=256),
        local_mapping=tcfg.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                              local_ba_points=1024, local_ba_iters=8))


def _run_stereo(seq, traced: bool):
    """The pipelined stereo loop over the sequence on a fresh system;
    returns (system, tracer spans or None)."""
    slam = StereoSlam(stereo_config(), enable_loop_closing=True, device="cpu")

    def frames():
        for i in range(N_FRAMES):
            slam.process_frame_stereo_pipelined(seq.images[i], seq.images_right[i],
                                                float(seq.timestamps[i]))
        slam.finish()

    if traced:
        with GLOBAL_TIMER.recording():
            frames()
        return slam, list(GLOBAL_TIMER.spans)
    frames()
    return slam, None


@pytest.fixture(scope="module")
def runs():
    seq = synthetic.make_sequence(stereo_config(), n_frames=N_FRAMES, n_points=500,
                                  seed=9, trajectory="forward")
    return _run_stereo(seq, traced=False), _run_stereo(seq, traced=True)


class _Clock:
    """A planted perf_counter_ns: each read returns the next value."""

    def __init__(self, values):
        self.values = iter(values)

    def __call__(self):
        return next(self.values)


def test_off_the_tracer_records_nothing_and_returns_the_shared_no_op():
    assert not GLOBAL_TIMER.on
    tr = timing.StageTimer()
    ctx = tr.stage("step")
    assert ctx is timing._NO_SPAN and tr.stage("frame", 3) is ctx
    with ctx as got:
        tr.count("host_syncs", 2)
    assert got is None and tr.spans == [] and tr.counts == []
    assert tr.summary() == {}


def test_nesting_parents_frame_ids_and_self_time_on_a_planted_tree(monkeypatch):
    """In ms: frame(7) [0, 100] > step [10, 60] > (extract [12, 30], match
    [30, 50]); frame(7) > finalize(6) [60, 95] > wait.readback [61, 71]; one
    count inside match, one inside finalize, one outside every span."""
    ms = 10 ** 6
    monkeypatch.setattr(timing.time, "perf_counter_ns",
                        _Clock([t * ms for t in (0, 10, 12, 30, 30, 50, 60, 60, 61, 71,
                                                 95, 100)]))
    tr = timing.StageTimer()
    tr.start(syncs=False)
    tr.count("host_syncs")
    with tr.stage("frame", 7):
        with tr.stage("step"):
            with tr.stage("step.extract"):
                pass
            with tr.stage("step.match"):
                tr.count("host_syncs", 2)
        with tr.stage("finalize", 6):
            tr.count("host_syncs")
            with tr.stage("wait.readback"):
                pass
    tr.stop()
    got = [(s.name, s.t0 // ms, s.t1 // ms, s.parent, s.frame) for s in tr.spans]
    assert got == [("frame", 0, 100, -1, 7), ("step", 10, 60, 0, 7),
                   ("step.extract", 12, 30, 1, 7), ("step.match", 30, 50, 1, 7),
                   ("finalize", 60, 95, 0, 6), ("wait.readback", 61, 71, 4, 6)]
    assert tr.self_ns() == [x * ms for x in (100 - 50 - 35, 50 - 38, 18, 20, 35 - 10, 10)]
    assert tr.counts == [(-1, "host_syncs", 1), (3, "host_syncs", 2), (4, "host_syncs", 1)]
    s = tr.summary()
    assert s["step"] == {"count": 1, "total_s": 0.05, "mean_ms": 50.0, "p50_ms": 50.0,
                         "p95_ms": 50.0}
    assert s["step:self"]["total_s"] == 0.012 and s["frame:self"]["p95_ms"] == 15.0
    assert set(k for k in s if k.endswith(":self")) == {"frame:self", "step:self",
                                                       "finalize:self"}
    assert s["step.match:host_syncs"] == {"count": 2}
    assert s["finalize:host_syncs"] == {"count": 1} and s["host_syncs"] == {"count": 1}
    # a new recording starts from empty records
    tr.start(syncs=False)
    tr.stop()
    assert tr.spans == [] and tr.counts == []


def test_summary_keeps_the_keys_run_slams_report_compares():
    """A span's row has the JAX package's StageTimer keys, which run_slam's
    report test compares for "frame"."""
    ref = jtiming.StageTimer()
    with ref.stage("frame"):
        pass
    tr = timing.StageTimer()
    with tr.recording(syncs=False):
        with tr.stage("frame", 0):
            with tr.stage("step"):
                pass
    s = tr.summary()
    assert s["frame"].keys() == ref.summary()["frame"].keys()
    assert s["step"].keys() == s["frame:self"].keys() == s["frame"].keys()
    assert tr.dump() == json.dumps(s, sort_keys=True)


def test_the_trajectory_and_stats_are_bit_identical_with_the_tracer_on(runs):
    (off, none), (on, spans) = runs
    assert none is None and spans
    assert off.stats == on.stats
    assert off.stats["kf_inserted"] >= 2
    assert [s for _, s in off.frame_log] == [s for _, s in on.frame_log]
    assert len(off.trajectory) == len(on.trajectory) == N_FRAMES
    for (ta, Ta), (tb, Tb) in zip(off.trajectory, on.trajectory):
        assert ta == tb and np.array_equal(Ta, Tb)
    for f in off.m._fields:
        a, b = getattr(off.m, f), getattr(on.m, f)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f


def test_the_pipelined_loop_finalizes_frame_i_inside_the_call_for_frame_i_plus_1(runs):
    _, (on, spans) = runs
    names = {s.name for s in spans}
    assert {"frame", "step", "step.extract", "step.stereo", "step.match", "step.pose_opt",
            "finalize", "keyframe", "mapping", "mapping.new_keyframe",
            "mapping.local_ba", "adopt", "place_recognition"} <= names
    frames = [s for s in spans if s.name == "frame"]
    assert [s.frame for s in frames] == list(range(N_FRAMES))

    def root(s):
        while s.parent >= 0:
            s = spans[s.parent]
        return s

    # frame 0 builds the map from its depth: no tracking decision
    finals = [s for s in spans if s.name == "finalize"]
    assert sorted(s.frame for s in finals) == list(range(1, N_FRAMES))
    piped = 0
    for s in finals:
        r = root(s)
        if r.name == "finalize":              # drained by finish(), the last frame
            assert s.frame == N_FRAMES - 1
        elif r.frame != s.frame:              # the pipelined loop
            assert r.frame == s.frame + 1 and r.t0 < s.t0 and s.t1 <= r.t1
            piped += 1
    assert piped >= N_FRAMES // 2
    # per frame: two matches and two pose optimisations inside its step
    for st in (s for s in spans if s.name == "step"):
        kids = [c.name for c in spans if c.parent == spans.index(st)]
        if "step.match" in kids:
            assert kids.count("step.match") == kids.count("step.pose_opt") == 2
    assert all(spans[s.parent].name == "mapping"
               for s in spans if s.name.startswith("mapping."))


def test_the_sync_counter_files_the_debug_modes_warnings_under_the_innermost_span():
    """On the CPU the mode itself cannot be set; the warning it raises is
    planted. Other warnings still show; the filters come back."""
    tr = timing.StageTimer()
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        filters = list(warnings.filters)
        with tr.recording():
            with tr.stage("adopt"):
                warnings.warn(timing.SYNC_WARNING)
                warnings.warn(timing.SYNC_WARNING)
                warnings.warn("something else")
        assert [str(w.message) for w in shown] == ["something else"]
        assert warnings.filters == filters
        warnings.warn(timing.SYNC_WARNING)
        assert len(shown) == 2
    assert tr.counts == [(0, "host_syncs", 1)] * 2
    assert tr.summary()["adopt:host_syncs"] == {"count": 2}


def test_the_tracer_is_off_again_after_an_exception():
    tr = timing.StageTimer()
    shown = timing.warnings.showwarning
    with pytest.raises(RuntimeError, match="inside"):
        with tr.recording():
            with tr.stage("frame", 0):
                raise RuntimeError("inside")
    assert not tr.on and tr.stage("step") is timing._NO_SPAN
    assert timing.warnings.showwarning is shown
    assert [s.name for s in tr.spans] == ["frame"] and tr.spans[0].t1 is not None
    tr.start()                      # no span is left open
    tr.stop()
    with pytest.raises(RuntimeError, match="already recording"):
        with tr.recording():
            tr.start()
    assert not tr.on
