"""The harness's code files, found by name: a system's driver
(``drivers/<system>.py``), a comparison (``compare/<kind>.py``), a traffic
generator (``generators/<name>.py``), a metric's reader
(``metrics/<name>.py``).

A cell's files are looked for under each of its roots in turn: the
directory its traffic and check files lie in, then slambench/ itself. So a
new system, comparison or generator enters as new files, and a cell kept
outside the package (the benchmark's own tests) can bring its own."""

from __future__ import annotations

import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def roots(root=None) -> tuple:
    """A cell's roots: `root` (its traffic and check files), then slambench/."""
    root = Path(root).resolve() if root else ROOT
    return (root,) if root == ROOT else (root, ROOT)


def load(kind: str, name: str, where: tuple = (ROOT,)):
    """The module of `<root>/<kind>/<name>.py` under the first root of
    `where` that has it; a SystemExit naming every path looked at where
    none has."""
    tried = [Path(r) / kind / f"{name}.py" for r in where]
    for path in tried:
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"slambench_{kind}_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise SystemExit(f"slambench: no {kind} file {name!r}: looked for "
                     + ", ".join(str(p) for p in tried))
