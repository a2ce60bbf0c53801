"""The serving programs inside the artifact (lctvqa_torch/programs.py and
`export.export_state(..., platforms=...)`), on the CPU.

Contract: every family's programs, int8 included, written by
`export_state(platforms=("cpu",))` and `save_artifact` and read back by
`programs.load_programs`, equal the eager `ServingModel` call bit for
bit at batches 1, 2 and 5, with no `pickle` or `torch.load` call while
reading, loading and calling; every member under `torch_exported/` is
JSON or a raw constant listed in JSON; a derived artifact's programs
load and run in a process that imports none of the model code, with no
genotype; the JAX package still reads the artifact; without platforms
the file is the bytes the parent's code path wrote (the JAX package's);
a buffer that is not the recorded one, a missing platform and a batch
above `max_batch` raise; an fp32 program runs with cuDNN's TF32 off and
restores it; the export CLI's `--platforms cpu --check` and the server's
`--programs` answer as the model code does.

Sizes are `small_test_config`'s, the supernet cut to two nodes a cell
as in tests/test_torch_export_programs.py; every artifact is made once
for the module, and each test reuses what an earlier one made.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lctvqa.export import read_artifact as jax_read_artifact
from lctvqa.export import save_artifact as jax_save_artifact
from lctvqa_torch import export, programs, serve
from lctvqa_torch.config import Config, small_test_config
from lctvqa_torch.models import genotypes, unified, vqa_ef, vqa_w
from lctvqa_torch.ops import conv
from test_torch_train import one_cpu_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
MAX_BATCH = 8
BATCHES = ((1, 10), (2, 11), (5, 12))
SMALL_SUPERNET = {"darts_steps": 2, "darts_multiplier": 2}
KERNEL_FLAGS = {"use_pallas_lstm": True, "pallas_seq_lstm": True,
                "pallas_generate": True, "pallas_mixed_op": True,
                "fold_bn_mixture": True}
FIXED = {"arch_type": "fixed", "img_size": 32}
DERIVED = {"arch_type": "derived", "genotype": genotypes.PC_DARTS_cifar}
# name -> (family, encoder dims and flags, int8, BatchNorm switch)
CASES = {
    "w": ("w", FIXED, False, False),
    "w_kernels": ("w", {**FIXED, **KERNEL_FLAGS}, False, True),
    "ef": ("ef", FIXED, False, False),
    "darts": ("ef", {"arch_type": "darts", **SMALL_SUPERNET,
                     **KERNEL_FLAGS}, False, True),
    "derived": ("ef", {**DERIVED, **KERNEL_FLAGS}, False, True),
    "unified": ("unified", {**FIXED, **KERNEL_FLAGS}, False, True),
    "w_int8": ("w", {**FIXED, **KERNEL_FLAGS}, True, True),
    "derived_int8": ("ef", {**DERIVED, **KERNEL_FLAGS}, True, True),
}


@contextlib.contextmanager
def bn_switch(on: bool):
    """The process-wide BatchNorm kernel switch, restored after."""
    was, conv.USE_PALLAS_BN = conv.USE_PALLAS_BN, on
    try:
        yield
    finally:
        conv.USE_PALLAS_BN = was


def _mcfg(name):
    _, dims, _, _ = CASES[name]
    return dataclasses.replace(small_test_config().model,
                               compute_dtype="float32", **dims)


def _state(name, mcfg):
    """A checkpoint's trees from the port's initializers; a supernet's
    arch parameters drawn anew, so that its mixture is not uniform."""
    family = CASES[name][0]
    gen = torch.Generator().manual_seed(3)
    if family == "w":
        return {"w_params": vqa_w.init_w_model(gen, mcfg)}
    if family == "unified":
        params, arch = unified.init_unified_model(gen, mcfg)
        return {"params": params, "arch": arch}
    params, arch = vqa_ef.init_ef_model(gen, mcfg)
    if mcfg.arch_type == "darts":
        arch = {k: torch.randn(v.shape, generator=gen)
                for k, v in arch.items()}
    return {"ef_params": params, "arch": arch}


def _words(size, first):
    return first + [f"t{i}" for i in range(size - len(first))]


class _Artifacts:
    """Each case's artifact file with its cpu programs, made at first
    use; the vocabularies in meta, so that a server decodes answers."""

    def __init__(self, root: Path):
        self.root, self.paths = root, {}

    def __getitem__(self, name):
        if name not in self.paths:
            family, _, int8, bn = CASES[name]
            mcfg = _mcfg(name)
            with bn_switch(bn):
                art = export.export_state(_state(name, mcfg), mcfg,
                                          int8=int8, platforms=("cpu",),
                                          max_batch=MAX_BATCH)
            vocab = {"qst_words": _words(mcfg.qst_vocab_size,
                                         ["<pad>", "<unk>", "<start>",
                                          "<end>"]),
                     "ans_words": _words(mcfg.ans_vocab_size, ["<unk>"])}
            if family == "unified":
                vocab = {"unified_words": vocab["qst_words"]}
            art["meta"].update(vocab)
            path = self.root / f"{name}.lctx"
            export.save_artifact(art, str(path))
            self.paths[name] = str(path)
        return self.paths[name]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return _Artifacts(tmp_path_factory.mktemp("program_artifacts"))


def _eager(name, path):
    mcfg = _mcfg(name)
    return export.load_artifact(
        path, "cpu", genotype=mcfg.genotype,
        **{f: getattr(mcfg, f) for f in export.SERVING_FIELDS})


def _inputs(mcfg, b, seed):
    rng = np.random.default_rng(seed)
    s = mcfg.img_size
    return (rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
            rng.integers(0, mcfg.qst_vocab_size, (b, mcfg.max_qst_len),
                         dtype=np.int32))


def _call(model, fn, u8, qst):
    out = model.answer_logits(u8, qst) if fn == "answer_logits" else \
        model.generate(u8)
    return out if isinstance(out, tuple) else (out,)


# ---------------------------------------------------------------------------
# the round trip, in a process without the model code
# ---------------------------------------------------------------------------

# loads each artifact's programs with pickle's loaders and torch.load
# refused and JAX and the JAX package blocked, calls every function at
# each batch on seeded inputs, saves inputs and outputs, and prints the
# model, export, data and JAX modules it imported
PROGRAM_RUN = """
import json, pickle, sys
for name in ("jax", "jaxlib", "lctvqa"):
    sys.modules[name] = None      # any import of it raises ImportError
import numpy as np
import torch

def refuse(*args, **kwargs):
    raise AssertionError("an unpickler ran")


class Refused(pickle.Unpickler):  # a class: modules subclass it on import
    __init__ = refuse


pickle.load = pickle.loads = torch.load = refuse
pickle.Unpickler = Refused
from lctvqa_torch import programs

torch.set_num_threads(1)  # the sums in the parent's order
for job in json.loads(sys.argv[1]):
    model = programs.load_programs(job["path"], "cpu")
    arrays = {}
    for b, seed in job["batches"]:
        rng = np.random.default_rng(seed)
        s, steps, vocab = job["img_size"], job["steps"], job["vocab"]
        u8 = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
        qst = rng.integers(0, vocab, (b, steps), dtype=np.int32)
        arrays[f"u8_{b}"], arrays[f"qst_{b}"] = u8, qst
        for fn in model.functions:
            out = (model.answer_logits(u8, qst) if fn == "answer_logits"
                   else model.generate(u8))
            for i, o in enumerate(out if isinstance(out, tuple) else (out,)):
                arrays[f"{fn}_{b}_{i}"] = o.numpy()
    np.savez(job["out"], **arrays)
print(json.dumps(sorted(m for m in sys.modules if sys.modules[m] is not None
                        and (m.split(".")[0] in ("jax", "jaxlib", "lctvqa")
                             or m.startswith(("lctvqa_torch.models",
                                              "lctvqa_torch.export",
                                              "lctvqa_torch.data"))))))
"""


def run_programs(artifacts, groups, out_dir: Path):
    """PROGRAM_RUN in a fresh process for each group of artifact names,
    started as soon as the group's artifacts are written, so that it
    loads their programs while this process exports the next group's (two
    processes at most) -> ({name: its saved inputs and outputs}, the
    modules they imported)."""
    def finish(names, proc):
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{names}: {err}"
        loaded.update(json.loads(out.strip().splitlines()[-1]))
        for name in names:
            outputs[name] = dict(np.load(str(out_dir / name) + ".npz"))

    outputs, loaded, running = {}, set(), None
    for names in groups:
        jobs = []
        for name in names:
            mcfg = _mcfg(name)
            jobs.append({"path": artifacts[name], "out": str(out_dir / name),
                         "batches": BATCHES, "img_size": mcfg.img_size,
                         "steps": mcfg.max_qst_len,
                         "vocab": mcfg.qst_vocab_size})
        if running is not None:
            finish(*running)
        running = (names, subprocess.Popen(
            [sys.executable, "-c", PROGRAM_RUN, json.dumps(jobs)], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=str(REPO)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    finish(*running)
    return outputs, sorted(loaded)


def check_round_trip(artifacts, run, name):
    """The programs' outputs from the file (`run_programs`) against the
    eager ServingModel's on the same inputs: bit for bit at batches 1, 2
    and 5, with their dtypes; the record names the flags, dtype, switch
    and batch they were exported with."""
    family, _, int8, bn = CASES[name]
    path, mcfg = artifacts[name], _mcfg(name)
    meta = programs.read_artifact(path)["meta"]
    rec = meta["torch_programs"]["cpu"]
    assert rec["functions"] == sorted(programs.FUNCTIONS[family])
    assert meta["int8"] == int8 and rec["batchnorm_kernel"] == bn
    assert rec["compute_dtype"] == "float32" and rec["max_batch"] == MAX_BATCH
    assert rec["flags"] == {f: getattr(mcfg, f)
                            for f in export.SERVING_FIELDS[1:]}
    got = run[0][name]
    eager = _eager(name, path)
    with bn_switch(bn):
        for b, _ in BATCHES:
            for fn in programs.FUNCTIONS[family]:
                want = _call(eager, fn, got[f"u8_{b}"], got[f"qst_{b}"])
                assert not f"{fn}_{b}_{len(want)}" in got
                for i, w in enumerate(want):
                    g = got[f"{fn}_{b}_{i}"]
                    assert g.dtype == w.numpy().dtype and g.shape[0] == b
                    assert np.array_equal(g, w.numpy()), (name, fn, b, i)


# the cases whose round trip this file runs; the int8 ones are
# test_torch_program_artifacts_int8.py's and the searched encoders'
# test_torch_program_artifacts_darts.py's, which share this file's helpers
# (one file would take more than a minute on one worker)
ROUND_TRIP = ("w", "w_kernels", "ef", "unified")


@pytest.fixture(scope="module")
def program_run(artifacts, tmp_path_factory):
    return run_programs(artifacts, (ROUND_TRIP,),
                        tmp_path_factory.mktemp("program_run"))


@pytest.mark.parametrize("name", ROUND_TRIP)
def test_programs_from_the_file_equal_the_eager_call(artifacts, program_run,
                                                     name):
    """Written by export_state(platforms=("cpu",)) and save_artifact, read
    back and loaded with no unpickler in a process without the model
    code, each function's program equals the eager call bit for bit."""
    check_round_trip(artifacts, program_run, name)


def test_programs_run_without_the_model_code(program_run):
    """The process that loaded and called every program above, with
    pickle's loaders and torch.load refused, imported neither the model
    code, the exporter, the data modules nor JAX."""
    assert program_run[1] == []


def check_members(path, family):
    """Under `torch_exported/<platform>/<name>/`: program.json (JSON),
    constants.json (JSON) and constants/<i>, each listed there with a
    dtype and shape whose bytes it has; nothing else."""
    with zipfile.ZipFile(path) as z:
        members = [n for n in z.namelist() if n.startswith("torch_exported/")]
        dirs = {n.rsplit("/", 2)[0] if "/constants/" in n
                else n.rsplit("/", 1)[0] for n in members}
        assert dirs == {f"torch_exported/cpu/{fn}"
                        for fn in programs.FUNCTIONS[family]}
        for d in dirs:
            json.loads(z.read(f"{d}/program.json"))
            consts = json.loads(z.read(f"{d}/constants.json"))
            raw = [n for n in members if n.startswith(f"{d}/constants/")]
            assert sorted(raw) == sorted(f"{d}/constants/{i}"
                                         for i in range(len(consts)))
            for i, spec in enumerate(consts):
                size = torch.empty((), dtype=getattr(
                    torch, spec["dtype"])).element_size()
                assert len(z.read(f"{d}/constants/{i}")) == size * int(
                    np.prod(spec["shape"]))
            assert {n for n in members if n.startswith(d + "/")} == {
                f"{d}/program.json", f"{d}/constants.json", *raw}


def test_program_members_are_json_or_listed_raw_constants(artifacts):
    check_members(artifacts["ef"], "ef")


def test_the_loader_imports_no_model_code():
    """programs.py's own imports: none of the model code, the exporter,
    the data modules, the quantizer (which imports the models), JAX or
    the JAX package."""
    import ast

    tree = ast.parse((REPO / "lctvqa_torch" / "programs.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom):
            names |= {n.module} | {f"{n.module}.{a.name}" for a in n.names}
    bad = sorted(m for m in names if m.split(".")[0] in ("jax", "lctvqa")
                 or m.startswith(tuple(f"lctvqa_torch.{p}" for p in (
                     "models", "export", "data", "quant"))))
    assert not bad, bad


# ---------------------------------------------------------------------------
# the file, read by the JAX package and without programs
# ---------------------------------------------------------------------------

def test_the_jax_package_reads_an_artifact_with_programs(artifacts):
    """lctvqa.export.read_artifact: the params equal the port's reading,
    and no StableHLO program is found."""
    path = artifacts["unified"]
    got = jax_read_artifact(path)
    want = programs.read_artifact(path)
    assert got["exported"] == {} and got["meta"] == want["meta"]
    assert sorted(want["torch_exported"]["cpu"]) == ["generate"]
    flat_got, flat_want = [], []
    programs._tree_to_skeleton(got["params"], flat_got)
    programs._tree_to_skeleton(want["params"], flat_want)
    assert len(flat_got) == len(flat_want) > 0
    for a, b in zip(flat_got, flat_want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_without_platforms_the_file_is_the_parents(tmp_path, monkeypatch):
    """export_state without platforms returns the parent's dict (no
    "torch_exported", no "torch_programs"), and save_artifact writes the
    bytes the parent's code path wrote, which were the JAX package's
    `save_artifact`'s (one frozen clock for the ZIP entries' times)."""
    mcfg = _mcfg("w")
    art = export.export_state(_state("w", mcfg), mcfg)
    assert sorted(art) == ["exported", "meta", "params"]
    assert "torch_programs" not in art["meta"]
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    export.save_artifact(art, str(tmp_path / "port.lctx"))
    jax_save_artifact(art, str(tmp_path / "jax.lctx"))
    monkeypatch.undo()
    assert ((tmp_path / "port.lctx").read_bytes()
            == (tmp_path / "jax.lctx").read_bytes())
    assert programs.read_artifact(str(tmp_path / "port.lctx"))[
        "torch_exported"] == {}


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_a_weight_of_another_shape_raises(artifacts):
    """A param leaf whose prepared buffer is not the recorded one raises
    before any program is loaded."""
    art = programs.read_artifact(artifacts["w"])
    fc2 = art["params"]["params"]["fc2"]
    fc2["b"] = np.zeros(fc2["b"].shape[0] + 1, fc2["b"].dtype)
    with pytest.raises(ValueError, match=r"params__fc2__b is float32 \["):
        programs.ProgramModel(art, "cpu")


def test_a_missing_platform_raises(artifacts, tmp_path):
    """Programs for the cuda platform only, or none, do not load on the
    CPU; the message names the platforms the artifact has."""
    art = programs.read_artifact(artifacts["w"])
    art["meta"]["torch_programs"] = {
        "cuda": art["meta"]["torch_programs"]["cpu"]}
    with pytest.raises(ValueError, match=r"for cpu; it has programs for "
                       r"\['cuda'\]"):
        programs.ProgramModel(art, "cpu")
    mcfg = _mcfg("w")
    plain = tmp_path / "plain.lctx"
    export.save_artifact(export.export_state(_state("w", mcfg), mcfg),
                         str(plain))
    with pytest.raises(ValueError, match=r"for cpu; it has programs for "
                       r"\[\]"):
        programs.load_programs(str(plain), "cpu")


def test_a_batch_above_max_batch_raises(artifacts):
    model = programs.load_programs(artifacts["w"], "cpu")
    u8, qst = _inputs(_mcfg("w"), MAX_BATCH + 1, 0)
    with pytest.raises(ValueError, match=f"a batch of {MAX_BATCH + 1}"):
        model.answer_logits(u8, qst)
    assert model.answer_logits(u8[:MAX_BATCH], qst[:MAX_BATCH]).shape[0] \
        == MAX_BATCH


class _Tf32AtConvolutions(TorchDispatchMode):
    """cuDNN's TF32 switch as each convolution dispatched sees it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.name().startswith("aten::conv"):
            self.seen.append(torch.backends.cudnn.allow_tf32)
        return func(*args, **(kwargs or {}))


def test_an_fp32_program_turns_tf32_off_and_restores_it(artifacts):
    """With cudnn.allow_tf32 on (PyTorch's default), an fp32 program's
    convolutions run with it off, as the eager fp32 convolution's on the
    card do; after the call it is on again."""
    model = programs.load_programs(artifacts["w"], "cpu")
    u8, qst = _inputs(_mcfg("w"), 2, 0)
    cudnn = torch.backends.cudnn
    was, cudnn.allow_tf32 = cudnn.allow_tf32, True
    try:
        with _Tf32AtConvolutions() as mode:
            model.answer_logits(u8, qst)
        assert mode.seen and not any(mode.seen), mode.seen
        assert cudnn.allow_tf32 is True
    finally:
        cudnn.allow_tf32 = was


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_export_cli_writes_and_checks_cpu_programs(tmp_path, capsys):
    """`python -m lctvqa_torch.export --platforms cpu --check --device
    cpu` on a W checkpoint: the artifact holds the cpu programs, the
    check holds them against the model, and the summary gives their
    bytes; --check on a platform without programs is refused."""
    from lctvqa_torch.train import checkpoint

    mcfg = _mcfg("w")
    (tmp_path / "E").mkdir()
    checkpoint.save_state(str(tmp_path / "E" / "w_model.ckpt"),
                          {**_state("w", mcfg), "epoch": 1},
                          config=Config(model=mcfg))
    argv = ["--exp", "E", "--root_stats_dir", str(tmp_path), "--model", "w",
            "--device", "cpu", "--platforms", "cpu", "--max_batch", "8"]
    out = export.main(argv + ["--check"])
    said = capsys.readouterr().out
    assert "check ok: the cpu programs ['answer_logits']" in said
    size = int(said.split("cpu programs ")[1].split(" bytes")[0])
    with zipfile.ZipFile(out) as z:
        assert size == sum(i.compress_size for i in z.infolist()
                           if i.filename.startswith("torch_exported/cpu/"))
    assert programs.read_artifact(out)["meta"]["torch_programs"]["cpu"][
        "max_batch"] == 8
    with pytest.raises(SystemExit):
        export.main(argv[:-4] + ["--platforms", "cuda", "--check"])


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def test_serve_programs_answers_as_the_model_code(artifacts):
    """The fixed EF artifact served with `programs=True` (serve's
    --programs) and by the model code at the checkpoint's flags: the same
    /answer and /generate replies; /healthz says which serves; a batcher
    whose largest bucket exceeds the programs' max_batch is refused, and
    so are --programs with --genotype."""
    mcfg, path = _mcfg("ef"), artifacts["ef"]
    flags = {f: getattr(mcfg, f) for f in export.SERVING_FIELDS}
    servers = [serve.make_server(path, port=0, window_ms=20.0, device="cpu",
                                 max_batch=MAX_BATCH, programs=True),
               serve.make_server(path, port=0, window_ms=20.0, device="cpu",
                                 max_batch=MAX_BATCH, **flags)]
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        ports = [srv.server_address[1] for srv in servers]
        assert [_get(p, "/healthz")["serving"] for p in ports] == [
            "programs", "model code"]
        rng = np.random.default_rng(7)
        replies = [[], []]
        for i in range(3):
            img = rng.integers(0, 256, (mcfg.img_size, mcfg.img_size, 3),
                               dtype=np.uint8).tolist()
            for k, port in enumerate(ports):
                replies[k].append(_post(port, "/answer",
                                        {"image": img, "question": "t3 t9"}))
                replies[k].append(_post(port, "/generate", {"image": img}))
        assert all(code == 200 for code, _ in replies[0])
        assert replies[0] == replies[1]
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    with pytest.raises(ValueError, match="more than the artifact's programs"):
        serve.make_server(artifacts["w"], port=0, device="cpu",
                          max_batch=MAX_BATCH + 1, programs=True)
    with pytest.raises(SystemExit):
        serve.main(["--artifact", path, "--device", "cpu", "--programs",
                    "--genotype", "PC_DARTS_cifar"])
