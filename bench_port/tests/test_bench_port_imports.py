"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program; top-level module names are
compared whole (the port's name begins with the JAX package's)."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "mupe_tpu"}


def imported_tops(path: Path):
    """(top-level module name, level) of every import in a file."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def sources(folder: Path):
    return [p for p in folder.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sources(BENCH):
        tops = {t for t, level in imported_tops(path) if level == 0}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    ref = BENCH / "reference"
    for path in sources(ref):
        for top, level in imported_tops(path):
            assert level or top not in {"mupe_tpu_torch", "bench_port"} | FORBIDDEN, (path, top)
            if level:
                # relative imports stay inside the reference's folder
                depth = len(path.relative_to(ref).parts) - 1
                assert level <= depth + 1, (path, level)


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    code = ("import sys, json; from pathlib import Path; from bench_port import core; "
            f"rc = core.main(['--workload', 'tiny.eval', '--seed', '2', '--seconds', '1'], "
            f"root=Path({str(tiny_root)!r}), device='cpu'); "
            "tops = sorted({m.split('.')[0] for m in sys.modules}); "
            "print(json.dumps({'rc': rc, 'tops': tops}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0 and not set(out["tops"]) & FORBIDDEN
    assert "mupe_tpu_torch" in out["tops"]
