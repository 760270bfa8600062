"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program it judges."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "zest_tpu"}


def _imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def _sources():
    return [p for p in PKG.rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for p in _sources():
        bad = _imported_tops(p) & FORBIDDEN
        assert not bad, f"{p} imports {bad}"


def test_names_compare_whole():
    # The port's name begins with the JAX package's: only a whole
    # top-level name counts.
    assert "zest_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "zest_tpu.models".split(".")[0] in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    tops = _imported_tops(PKG / "reference.py")
    assert "zest_tpu_torch" not in tops and not tops & FORBIDDEN
    assert tops <= {"__future__", "json", "math", "struct", "numpy",
                    "torch"}


def test_loading_every_module_loads_no_jax():
    code = (
        "import sys, importlib, pathlib\n"
        f"pkg = pathlib.Path({str(PKG)!r})\n"
        "sys.path.insert(0, str(pkg.parent))\n"
        "for p in sorted(pkg.glob('*.py')):\n"
        "    importlib.import_module('portbench.' + p.stem)\n"
        "import portbench.run as r, portbench.cells as c\n"
        "spec = r.Spec()\n"
        "for m in spec.bench['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "import zest_tpu_torch.transfer.pull, zest_tpu_torch.models.hbm_pool\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        f"print(sorted(tops & set({sorted(FORBIDDEN)!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_alone_loads_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(PKG.parent)!r})\n"
        "import portbench.reference\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'zest_tpu_torch', 'zest_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
