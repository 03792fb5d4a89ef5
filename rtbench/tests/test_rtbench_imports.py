"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``raytrace2_tpu_torch`` is the port), the reference
imports nothing of the port, and a run leaves none of them loaded."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from rtbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "raytrace2_tpu"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p in harness.PKG.rglob("*.py") if "_cache" not in p.parts]
    assert len(files) > 20
    for path in files:
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    for path in (harness.PKG / "reference").glob("*.py"):
        assert "raytrace2_tpu_torch" not in _imports(path), path
        assert not (_imports(path) & FORBIDDEN), path


def test_whole_names_are_compared():
    assert "raytrace2_tpu_torch" not in FORBIDDEN
    assert set(harness.FORBIDDEN) == FORBIDDEN


def test_a_run_leaves_no_forbidden_module_loaded():
    code = ("from rtbench.tests._tiny import run_cpu; from rtbench import harness; "
            "run_cpu('cornell600.final', seconds=0.05); print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "rtbench.run", "--workload", "cornell600.final",
                          "--seed", "1", "--seconds", "1"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    if out.returncode == 0:  # a card is present: the run printed its line
        assert '"correct"' in out.stdout.strip().splitlines()[-1]
    else:
        assert out.stdout.strip() == "" and "rtbench:" in out.stderr
