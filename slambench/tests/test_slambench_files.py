"""A system enters the benchmark as files alone (slambench/harness/files.py),
on the CPU at the tiny cell's size: a cell kept in a directory of its own
names a new system, and its driver, comparison and traffic generator are
new files beside its traffic and check files, none in slambench/; its run
is sound and correct. A system with no driver file fails and names the
file it looked for; a driver whose `checked` capture kind is never offered
reads `correct` false, though every compared number is within its limit."""

import json
import textwrap

import pytest

from slambench import run
from slambench.tests.conftest import DATA

SEED = 2 ** 31 + 13
SECONDS = 60.0          # longer than the tiny sequence lasts: the window spends it

FILES = {
    # the new system's driver: the stereo driver fed from the generator's own
    # field, with a comparison of its own
    "drivers/twin.py": '''
        from slambench.drivers import stereo


        class Driver(stereo.Driver):
            compared = ("twin_step", "k2", "bow")

            def round(self):
                i, fr = self.pos, self.frames[0]
                if i >= fr.left.shape[0]:
                    return 0
                with self.sp.span("frame"):
                    self.slam.process_frame_stereo_pipelined(fr.left[i], fr.right[i],
                                                             int(fr.stamps_ns[i]) / 1e9)
                self.pos += 1
                return 1
        ''',
    # a driver that names a capture kind it never offers
    "drivers/blind.py": '''
        from slambench.drivers import stereo


        class Driver(stereo.Driver):
            checked = "stereo_pair"
        ''',
    "compare/twin_step.py": '''
        from slambench.compare.step import check, control  # noqa: F401

        CAPTURES = ("step",)
        ''',
    # the generator's own frames type: the rendered frames and a clock in ns
    "generators/twin.py": '''
        import dataclasses

        import numpy as np

        from slambench.harness import traffic as tr


        @dataclasses.dataclass
        class TwinFrames(tr.AgentFrames):
            stamps_ns: np.ndarray = None


        def generate(traffic, camera, seed, device):
            plain = {k: v for k, v in traffic.items() if k != "generator"}
            return [TwinFrames(**vars(a), stamps_ns=np.round(a.timestamps * 1e9).astype(np.int64))
                    for a in tr.generate(plain, camera, seed, device)]
        ''',
}


def _cell_dir(root, system, traffic_over):
    """A cell tiny_<system>.revisit in `root`: the tiny stereo cell's files
    with the configuration's system and the traffic file's keys replaced."""
    bench = json.loads((DATA / "BENCHMARK.json").read_text())
    conf = json.loads((DATA / "configs" / "tiny_stereo.json").read_text())
    tfc = json.loads((DATA / "traffic" / "tiny_revisit.json").read_text())
    cell = f"tiny_{system}.revisit"
    bench["configs"] = [dict(bench["configs"][0], name=f"tiny_{system}",
                             file=f"configs/tiny_{system}.json")]
    bench["workloads"] = [dict(bench["workloads"][0], name=cell, config=f"tiny_{system}",
                               traffic=f"{system}_revisit")]
    for sub in ("configs", "traffic", "checks"):
        (root / sub).mkdir(exist_ok=True)
    (root / f"BENCHMARK.{system}.json").write_text(json.dumps(bench))
    (root / "configs" / f"tiny_{system}.json").write_text(json.dumps(dict(conf, system=system)))
    (root / "traffic" / f"{system}_revisit.json").write_text(json.dumps(dict(tfc,
                                                                             **traffic_over)))
    (root / "checks" / f"{cell}.json").write_text(
        (DATA / "checks" / "tiny_stereo.revisit.json").read_text())
    return cell


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    root = tmp_path_factory.mktemp("cells")
    for sub in ("drivers", "compare", "generators"):
        (root / sub).mkdir()
    for rel, src in FILES.items():
        (root / rel).write_text(textwrap.dedent(src).lstrip())
    _cell_dir(root, "twin", {"generator": "twin"})
    # a short sequence: its verdict is the point, not its length
    _cell_dir(root, "blind", {"frames_per_agent": 48})
    _cell_dir(root, "nosuch", {})
    return root


def _run(root, system):
    lines = []
    res = run.run(f"tiny_{system}.revisit", SEED, SECONDS, trace=False, device_name="cpu",
                  bench_path=root / f"BENCHMARK.{system}.json", root=root,
                  emit=lambda line: lines.append(json.loads(line)))
    return res, lines


def test_a_new_system_enters_through_files_alone(cells):
    res, lines = _run(cells, "twin")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and set(res["metrics"]) == {"frames_per_s", "setup_s"}
    stereo = json.loads((DATA / "checks" / "tiny_stereo.revisit.json").read_text())
    assert list(res["checks"]) == list(stereo["numbers"])
    assert all(row["value"] is not None and row["value"] < 1e-5
               for row in res["checks"].values()), res["checks"]
    work = lines[1]["work"]
    assert work["frames"] == res["attempted"]


def test_an_unknown_system_fails_naming_the_missing_file(cells):
    with pytest.raises(SystemExit, match=r"drivers/nosuch\.py") as e:
        _run(cells, "nosuch")
    assert str(cells / "drivers" / "nosuch.py") in str(e.value)


def test_a_driver_whose_checked_kind_is_never_offered_is_not_correct(cells):
    res, _ = _run(cells, "blind")
    assert res["attempted"] > 0
    assert all(row["value"] is None or row["value"] <= row["limit"]
               for row in res["checks"].values()), res["checks"]
    assert res["correct"] is False
