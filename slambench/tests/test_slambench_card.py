"""On the card, at the test size: a sound run is correct, and the control
(the plain reference computed with TF32 on, put in the port's place) is
not. `python3 -m pytest slambench/tests -q -m cuda` on the chip; these
skip without a card."""

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
