"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level module names are compared
whole: the port's name begins with the JAX package's."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "multi_orbslam3_tpu"}
PORT = "multi_orbslam3_tpu_torch"


def _imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 20
    bad = {str(p.relative_to(ROOT)): sorted(_imported_tops(p) & FORBIDDEN) for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((ROOT / "reference").rglob("*.py"))
    assert files
    bad = [str(p) for p in files if PORT in _imported_tops(p) or PORT in p.read_text()
           .replace(f'"{PORT}" / "bow"', "")]
    assert not bad


def test_the_scan_sees_a_forbidden_import(tmp_path):
    (tmp_path / "m.py").write_text("import jax.numpy as jnp\nfrom multi_orbslam3_tpu.x import y\n"
                                   "import multi_orbslam3_tpu_torch\n")
    assert _imported_tops(tmp_path / "m.py") & FORBIDDEN == {"jax", "multi_orbslam3_tpu"}
