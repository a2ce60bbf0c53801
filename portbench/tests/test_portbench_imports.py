"""Nothing a benchmark run reaches imports JAX or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's), nothing under `portbench/reference/` imports the program,
and nothing of the benchmark reads the JAX package's benchmark files."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "lctvqa"}


def _sources(under: Path):
    return [p for p in sorted(under.rglob("*.py")) if "tests" not in p.parts]


def _imported(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", _sources(HERE),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_benchmark_source_imports_jax_or_the_jax_package(path):
    assert not _imported(path) & FORBIDDEN
    text = path.read_text()
    for name in ("bench.py", "BENCH_r0", "MULTICHIP_r0", "scripts/",
                 "baseline_cpu.json"):
        assert name not in text


@pytest.mark.parametrize("path", _sources(HERE / "reference"),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "lctvqa_torch" not in _imported(path)


def test_a_run_holds_no_jax_module_after_its_window():
    """A tiny run in a process of its own; the same look as the
    harness's at the end of a run."""
    code = (
        "import sys, json, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(HERE / 'tests')!r}]\n"
        "from conftest import tiny_spec\n"
        "from portbench import run\n"
        "for cell in ('lct_train_224', 'vqa_answer_224', 'ef_generate_224'):\n"
        "    run.execute(tiny_spec(cell), 5, 0.5, False,"
        " torch.device('cpu'))\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
