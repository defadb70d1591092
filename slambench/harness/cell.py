"""A cell of BENCHMARK.json: its configuration and traffic files, found by
name, the roots its code files are looked for under
(slambench/harness/files.py), and the port's SystemConfig built from the
configuration file."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

from slambench.harness import files

ROOT = Path(__file__).resolve().parent.parent
REPO = ROOT.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict            # the configuration file as run
    traffic: dict           # the traffic file
    end_to_end: list        # BENCHMARK.json metric entries of this cell
    per_layer: list
    check: dict             # slambench/checks/<cell>.json: the compared numbers' limits
    roots: tuple            # where its drivers/, compare/, generators/ files are looked for


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Optional[Path] = None, root: Optional[Path] = None) -> Cell:
    """The cell `name` of BENCHMARK.json (or of bench_path, whose config
    files lie relative to it, with traffic and check files under root)."""
    bench_path = Path(bench_path) if bench_path else REPO / "BENCHMARK.json"
    root = Path(root) if root else ROOT
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"slambench: no workload {name!r} in BENCHMARK.json "
                         f"(known: {', '.join(sorted(cells))})")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((bench_path.parent / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    check = json.loads((root / "checks" / f"{name}.json").read_text())
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                check=check, roots=files.roots(root))


def system_config(config: dict):
    """The port's SystemConfig from a configuration file: every group of
    SystemConfig is a JSON object of that group's fields (lists become
    tuples); a group the file leaves out keeps the port's defaults."""
    from multi_orbslam3_tpu_torch import config as cfgm
    kw = {"sensor": config["sensor"]}
    for f in dataclasses.fields(cfgm.SystemConfig):
        if f.name == "sensor" or f.name not in config:
            continue
        group_cls = type(getattr(cfgm.SystemConfig(), f.name))
        vals = {k: tuple(v) if isinstance(v, list) else v
                for k, v in config[f.name].items()}
        kw[f.name] = group_cls(**vals)
    return cfgm.SystemConfig(**kw)
