"""On the card, at the test size: a sound run is correct, and the control
(the plain reference computed with TF32 on, put in the port's place) is
not; a traced run keeps its traced frames and reads every per-layer metric
of its cell. `python3 -m pytest slambench/tests -q -m cuda` on the chip;
these skip without a card."""

import json

import pytest

from slambench import run
from slambench.harness import check
from slambench.harness.cell import load_cell
from slambench.tests.conftest import DATA


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny_stereo.revisit"])
def test_the_control_is_not_correct(card, cell):
    res = run.run(cell, 2 ** 31 + 29, 20.0, trace=False, bench_path=DATA / "BENCHMARK.json",
                  root=DATA, control=True, emit=lambda line: None)
    assert res["correct"], res["checks"]
    limits = load_cell(cell, DATA / "BENCHMARK.json", DATA).check["numbers"]
    ok, rows = check.verdict(res["control"], limits)
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny_stereo.revisit"])
def test_a_traced_run_keeps_its_traced_frames(card, cell):
    """The window outlasts the tiny sequence, as it does the cell's on a
    fast host: it stops where the traced frames begin, so the trace and
    every per-layer metric are there."""
    lines = []
    res = run.run(cell, 2 ** 31 + 31, 60.0, trace=True, bench_path=DATA / "BENCHMARK.json",
                  root=DATA, emit=lambda line: lines.append(json.loads(line)))
    c = load_cell(cell, DATA / "BENCHMARK.json", DATA)
    rounds = c.traffic["trace"]["rounds"]
    assert res["correct"], res["checks"]
    assert lines[1]["work"]["frames_left"] == rounds and lines[2]["spans"]["frames"] == rounds
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
    assert set(res["metrics"]) == {m["name"] for m in c.per_layer}
