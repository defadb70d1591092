"""The harness driven end to end on the CPU at a tiny size (the chip check
skipped, the port's plain kernels), once sound and once with each fault the
cells can have planted under the timed path: `correct` has to come out
true for the sound run and false for every fault. The tiny cells live in
slambench/tests/data."""

import pytest
import torch

from slambench import run
from slambench.tests.conftest import DATA

SEED = 2 ** 31 + 11
CELLS = ["tiny_stereo.revisit"]
# longer than the tiny sequence lasts on the CPU: the window ends when its
# frames are spent, so every run does the same work
SECONDS = 60.0


def _run(cell, fault=None):
    return run.run(cell, SEED, SECONDS, trace=False, device_name="cpu",
                   bench_path=DATA / "BENCHMARK.json", root=DATA, fault=fault,
                   emit=lambda line: None)


def _pose_unchanged(sp):
    """A step that returns its state unchanged: the tracked pose is the
    pose the step started from."""
    from multi_orbslam3_tpu_torch.pipeline import tracking

    def make(orig):
        def step(config, m, il, ir, T_cur, T_vel):
            feats, sd, res, pose, tvel = orig(config, m, il, ir, T_cur, T_vel)
            return feats, sd, res._replace(pose=T_cur), T_cur, T_vel
        return step

    sp.replace(tracking, "fused_step_stereo_chained", make)


def _half_the_features(sp):
    """Half of the batch left out: the second half of every frame's
    features dropped where the extractor produces them."""
    from multi_orbslam3_tpu_torch.frontend import extractor

    def cut(f):
        n = f.valid.shape[0]
        keep = torch.arange(n, device=f.valid.device) < n // 2
        return f._replace(valid=f.valid & keep)

    sp.replace(extractor, "_features_from_scores",
               lambda orig: lambda *a, **k: cut(orig(*a, **k)))


def _k2_answer_altered(sp):
    """A K2 answer altered where it is produced: the projection search's
    best distance of its first valid row is off by one."""
    from multi_orbslam3_tpu_torch.frontend import kernels

    def make(orig):
        def search(*args):
            idx, best, second = orig(*args)
            rows = torch.nonzero(args[2])[:, 0]
            if rows.numel():
                best = best.clone()
                best[rows[0]] += 1
            return idx, best, second
        return search

    sp.replace(kernels, "hamming_best_two_projection", make)


def _bow_score_altered(sp):
    """Place-recognition scores altered where they are produced: every
    row's score 0.01 higher (also the rows the covisible group excludes,
    which the tiny map's queries are made of)."""
    from multi_orbslam3_tpu_torch.bow import database as dbm
    sp.replace(dbm, "query", lambda orig: lambda *a, **k: orig(*a, **k) + 0.01)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    # every number sampled, and the reference agrees with the port's plain
    # path to float32 rounding here
    assert all(row["value"] is not None and row["value"] < 1e-5
               for row in res["checks"].values()), res["checks"]


FAULTS = [("tiny_stereo.revisit", _pose_unchanged), ("tiny_stereo.revisit", _half_the_features),
          ("tiny_stereo.revisit", _k2_answer_altered), ("tiny_stereo.revisit", _bow_score_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault):
    res = _run(cell, fault)
    assert res["correct"] is False, res["checks"]
