"""The port stands alone: `lctvqa_torch` and `chip_smoke.py` import
neither JAX nor the JAX package `lctvqa`, not even a module there that
does not use JAX. The port keeps its own copy of what it needs.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "lctvqa_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "lctvqa")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from ((a.name, node.lineno) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, node.lineno


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_neither_jax_nor_lctvqa(path):
    bad = [(name, line) for name, line in _imported_modules(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


BLOCK = """
import sys
for name in ("jax", "jaxlib", "lctvqa"):
    sys.modules[name] = None      # any import of it raises ImportError
"""
LOADED = """
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "lctvqa") and sys.modules[m] is not None)
assert not loaded, loaded
print("ok")
"""
RUNS = {
    # lctvqa_torch.serve (and so export, the models, the ops and the
    # kernel wrappers); a darts EF model then initialises and runs
    "serve": """
import dataclasses
import torch
import lctvqa_torch.serve
from lctvqa_torch.config import small_test_config
from lctvqa_torch.models import vqa_ef
cfg = small_test_config().model
params, arch = vqa_ef.init_ef_model(torch.Generator().manual_seed(0), cfg)
img = torch.zeros(2, cfg.img_size, cfg.img_size, 3)
tok, ans = vqa_ef.ef_generate(params, arch, cfg, img)
assert tok.shape == (2, cfg.max_qst_len)
assert ans.shape == (2, cfg.ans_vocab_size)
""",
    # python -m lctvqa_torch.export --help (the CLI, quant.py, ops/int8.py,
    # the checkpoint reader)
    "export-help": """
import runpy
sys.argv = ["lctvqa_torch.export", "--help"]
try:
    runpy.run_module("lctvqa_torch.export", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
import lctvqa_torch.quant, lctvqa_torch.train.stats
""",
    # the C++ data-loader core built (or found built), loaded and run, and
    # the offline builders and download list imported, with no file of the
    # JAX package opened: an audit hook sees every open, dlopen and
    # subprocess
    "native": """
import os, pathlib
import numpy as np
jax_dir = str(pathlib.Path("lctvqa").resolve()) + os.sep
seen = []
def hook(event, args):
    if event in ("open", "ctypes.dlopen", "subprocess.Popen"):
        seen.append(repr(args))
sys.addaudithook(hook)
import lctvqa_torch.data.build, lctvqa_torch.data.download
import lctvqa_torch.data.preprocess, lctvqa_torch.data.pipeline
from lctvqa_torch import native
from lctvqa_torch.native import build as nbuild
assert native.available()
src = np.arange(6, dtype=np.uint8).reshape(3, 2)
assert native.gather_rows(src, [2, 0]).tolist() == [[4, 5], [0, 1]]
lib = pathlib.Path(native._lib._name)
assert lib.parent == pathlib.Path("build/native").resolve(), lib
assert nbuild.SRC == pathlib.Path("lctvqa_torch/native/src/native.cpp"
                                  ).resolve()
assert any("liblctvqa_native_" in s for s in seen), seen
bad = [s for s in seen if jax_dir in s]
assert not bad, bad
""",
}


@pytest.mark.parametrize("run", list(RUNS))
def test_serve_loads_with_jax_and_lctvqa_blocked(run):
    """`import lctvqa_torch.serve`, `python -m lctvqa_torch.export
    --help`, and the C++ core with the data modules, with `jax` and
    `lctvqa` made unimportable: no module of either is loaded."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", BLOCK + RUNS[run] + LOADED],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    if run == "export-help":
        assert "--int8" in proc.stdout and "torch.export" in proc.stdout
