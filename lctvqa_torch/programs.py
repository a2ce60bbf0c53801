"""The artifact file and the serving programs in it, with no model code
(the counterpart of lctvqa/export.py's `ServingModel`, which runs an
artifact's StableHLO with none of the model code).

An artifact is one ZIP file (no pickle):

    meta.json                              the meta dict (JSON)
    tree.json                              the param tree's skeleton and
                                           each leaf's dtype and shape
    leaves/<i>                             raw little-endian bytes of leaf i
    exported/<name>                        the JAX package's StableHLO,
                                           carried through, never run here
    torch_exported/<platform>/<name>/      the port's programs, where the
        program.json                       export wrote them: the graph, as
                                           torch.export's schema in JSON
        constants.json                     its lifted constants' names,
        constants/<i>                      dtypes, shapes, and raw bytes

The first four are the JAX package's format, so either package reads
what the other wrote; the JAX reader takes every `exported/<name>` for
StableHLO, which is why the port's programs live elsewhere. Params are
in the JAX layout (`convert.to_jax`).

A program is one serving function (`answer_logits`, `generate`) traced
by `export.export_programs` on one platform, "cuda" or "cpu", where it
asserts its inputs' device. Its weights are not in the file: they are
the *prepared* tree (cast for the compute dtype, packed for the
kernels), which `prepare_serving_tree` rebuilds from the raw leaves on
load, so the file holds the weights once whatever the number of
programs. `meta["torch_programs"][platform]` records the functions, the
compute dtype and kernel flags the weights are prepared for, the
BatchNorm kernel switch at trace time, the largest batch, the PyTorch
version, and each buffer's name, dtype and shape, which a load checks
before any call.

`load_programs(path, device)` -> `ProgramModel`: the programs with
their buffers, ServingModel's surface, and nothing of
`lctvqa_torch.models`, `.export` or `.data` imported. Its kernels are
the `lctvqa_torch::` operators (`ops/_build.py::define_op`), registered
when `lctvqa_torch.ops` is imported and built at their first launch on
the card. An fp32 program runs with cuDNN's TF32 off
(`ops/conv.py::_no_tf32`), as the eager fp32 convolution does: a traced
program does not carry that switch.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import pickle
import threading
import types
import typing
import zipfile
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Union

import numpy as np
import torch

from lctvqa_torch import convert
from lctvqa_torch.ops import (  # noqa: F401 (registers the operators)
    cuda_bn, cuda_generate, cuda_mixedop, cuda_vgg)
from lctvqa_torch.ops import nn as N
from lctvqa_torch.ops.conv import _no_tf32
from lctvqa_torch.ops.cuda_lstm import cell_weights
from lctvqa_torch.ops.cuda_mixedop import node_weights
from lctvqa_torch.text import extract_answer_words

ARTIFACT_VERSION = 1
PROGRAMS_DIR = "torch_exported"
PLATFORMS = ("cuda", "cpu")

FUNCTIONS = {"w": ("answer_logits",), "ef": ("answer_logits", "generate"),
             "unified": ("generate",)}
# the ModelConfig fields a served model takes from the checkpoint's config
SERVING_FIELDS = ("compute_dtype", "use_pallas_lstm", "pallas_seq_lstm",
                  "pallas_generate", "pallas_mixed_op", "fold_bn_mixture")


# ---------------------------------------------------------------------------
# the artifact file
# ---------------------------------------------------------------------------

def _tree_to_skeleton(tree, leaves: list):
    """JSON-able skeleton of a params tree; array leaves are appended to
    `leaves` and replaced by their index. Node types are tagged so that
    the rebuilt tree has exactly the written structure (tuple or list
    matters to the JAX package's exported call)."""
    if isinstance(tree, dict):
        return {"__d__": {k: _tree_to_skeleton(v, leaves)
                          for k, v in tree.items()}}
    if isinstance(tree, list):
        return {"__l__": [_tree_to_skeleton(v, leaves) for v in tree]}
    if isinstance(tree, tuple):
        return {"__t__": [_tree_to_skeleton(v, leaves) for v in tree]}
    leaves.append(np.asarray(tree))
    return {"__leaf__": len(leaves) - 1}


def _skeleton_to_tree(skel, leaves: list):
    if "__leaf__" in skel:
        return leaves[skel["__leaf__"]]
    if "__d__" in skel:
        return {k: _skeleton_to_tree(v, leaves)
                for k, v in skel["__d__"].items()}
    if "__l__" in skel:
        return [_skeleton_to_tree(v, leaves) for v in skel["__l__"]]
    return tuple(_skeleton_to_tree(v, leaves) for v in skel["__t__"])


def _np_dtype(name: str):
    try:
        return np.dtype(name)
    except TypeError:  # bfloat16 etc. live in ml_dtypes
        import ml_dtypes
        return np.dtype(getattr(ml_dtypes, name))


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save_artifact(artifact: Dict[str, Any], path: str) -> None:
    """Write {"exported", "params", "meta"[, "torch_exported"]} as the ZIP
    described above. `params` is a tree of numpy arrays in the JAX
    layout; "torch_exported" is {platform: {name: program_files(...)}}.
    Without programs the file is the JAX package's, byte for byte."""
    leaves: list = []
    skeleton = _tree_to_skeleton(artifact["params"], leaves)
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(artifact["meta"]))
        z.writestr("tree.json", json.dumps(
            {"skeleton": skeleton,
             "leaves": [{"dtype": a.dtype.name, "shape": list(a.shape)}
                        for a in leaves]}))
        for i, a in enumerate(leaves):
            z.writestr(f"leaves/{i}", a.tobytes())
        for name, blob in artifact["exported"].items():
            z.writestr(f"exported/{name}", blob)
        for platform, programs in artifact.get(PROGRAMS_DIR, {}).items():
            for name, files in programs.items():
                where = f"{PROGRAMS_DIR}/{platform}/{name}"
                z.writestr(f"{where}/program.json", files["program"])
                consts = list(files["constants"].items())
                z.writestr(f"{where}/constants.json", json.dumps(
                    [{"name": k, "dtype": _dtype_name(t),
                      "shape": list(t.shape)} for k, t in consts]))
                for i, (_, t) in enumerate(consts):
                    z.writestr(f"{where}/constants/{i}", _raw(t))
    os.replace(tmp, path)


def _raw(t: torch.Tensor) -> bytes:
    """A tensor's bytes, little-endian, in row-major order."""
    return t.detach().cpu().contiguous().reshape(-1).view(
        torch.uint8).numpy().tobytes()


def _read_programs(z: zipfile.ZipFile) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for n in z.namelist():
        parts = n.split("/")
        if parts[0] != PROGRAMS_DIR or parts[-1] != "program.json":
            continue
        platform, name = parts[1], parts[2]
        where = f"{PROGRAMS_DIR}/{platform}/{name}"
        consts = {}
        specs = json.loads(z.read(f"{where}/constants.json"))
        for i, spec in enumerate(specs):
            raw = np.frombuffer(z.read(f"{where}/constants/{i}"), np.uint8)
            consts[spec["name"]] = torch.from_numpy(raw.copy()).view(
                getattr(torch, spec["dtype"])).reshape(spec["shape"])
        out.setdefault(platform, {})[name] = {"program": z.read(n),
                                              "constants": consts}
    return out


def read_artifact(path: str, trusted: bool = False) -> Dict[str, Any]:
    """Read an artifact file -> artifact dict ("torch_exported" empty where
    it holds no programs). ZIP artifacts (the current format) load with
    no code execution; legacy pickle artifacts require trusted=True
    (serve CLI: --trusted)."""
    if not zipfile.is_zipfile(path):
        if not trusted:
            raise ValueError(
                f"{path} is a legacy pickle artifact; pickle.load executes "
                "arbitrary code from the file. Pass trusted=True/--trusted "
                "only for artifacts you produced yourself, or re-export")
        with open(path, "rb") as f:
            return pickle.load(f)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        tree = json.loads(z.read("tree.json"))
        leaves = [
            np.frombuffer(z.read(f"leaves/{i}"),
                          _np_dtype(spec["dtype"])).reshape(spec["shape"])
            for i, spec in enumerate(tree["leaves"])]
        params = _skeleton_to_tree(tree["skeleton"], leaves)
        exported = {n[len("exported/"):]: z.read(n) for n in z.namelist()
                    if n.startswith("exported/")}
        programs = _read_programs(z)
    return {"exported": exported, "params": params, "meta": meta,
            PROGRAMS_DIR: programs}


# ---------------------------------------------------------------------------
# the served weights
# ---------------------------------------------------------------------------

def _prepare(tree, dtype: Optional[torch.dtype], node_kernel: bool = False):
    """The weights cast for the compute dtype once, at load, so that no
    call casts them again: linear weights rounded to it (kept fp32), conv
    weights (dense, depthwise and pointwise alike) cast to it, each LSTM
    layer's kernel weights under "cell" and, with `node_kernel`, each
    stride-1 mixed op's packed fp32 kernel weights under "node". int8
    weights stay int8 (an int8 linear's [in, out] weight is laid out
    column-major, the operand layout of the card's int8 GEMM)."""
    if isinstance(tree, list):
        return [_prepare(t, dtype, node_kernel) for t in tree]
    if not isinstance(tree, dict):
        return tree
    if "w_q" in tree:
        w_q = tree["w_q"]
        return {**tree, "w_q": w_q.t().contiguous().t()
                if w_q.dim() == 2 else w_q}
    if "w_ih" in tree:
        return {**tree, "cell": cell_weights(tree, dtype)}
    if "w" in tree and tree["w"].dim() == 2:
        return N.prepare_linear(tree, dtype)
    if "w" in tree and dtype is not None:
        return {**tree, "w": tree["w"].to(dtype)}
    out = {k: _prepare(v, dtype, node_kernel) for k, v in tree.items()}
    # a mixed op; on a stride-1 edge skip_connect has no params
    if node_kernel and "sep_conv_3x3" in tree and not tree["skip_connect"]:
        out["node"] = node_weights(tree)
    return out


def _has_int8(tree) -> bool:
    """Whether a param tree holds a quantized conv or linear ("w_q")."""
    if isinstance(tree, dict):
        return "w_q" in tree or any(_has_int8(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_int8(v) for v in tree)
    return False


def prepare_serving_tree(params, arch, family: str,
                         dtype: Optional[torch.dtype],
                         flags: Mapping[str, Any],
                         device: Union[str, torch.device]):
    """An artifact's params and arch (JAX layout) -> (the prepared params,
    the arch) as tensors on `device`: the weights cast and packed once
    for `dtype` and the kernel `flags` (SERVING_FIELDS), the node's
    packed weights with `pallas_mixed_op` and `fold_bn_mixture`, and the
    decoder's ("qst", or a unified model's "qa") cast and padded decode
    weights under "decode" with `pallas_generate`. The eager model and
    the programs' buffers both come from here."""
    prepared = _prepare(convert.from_jax(params, device), dtype,
                        node_kernel=bool(flags["pallas_mixed_op"]
                                         and flags["fold_bn_mixture"]))
    if family != "w" and flags["pallas_generate"]:
        dec = prepared["qa" if family == "unified" else "qst"]
        dec["decode"] = cuda_generate.decode_weights(dec, dtype)
    return prepared, (None if arch is None
                      else convert.from_jax(arch, device))


# ---------------------------------------------------------------------------
# the programs' buffers
# ---------------------------------------------------------------------------

class _Buffer(NamedTuple):
    """A tensor leaf of a serving module's tree: the buffer that holds it."""

    name: str


def _register_tree(module: torch.nn.Module, tree, path: str, seen: dict):
    """The tree with each tensor replaced by a `_Buffer`, the tensor
    registered as a buffer of `module` named by its tree path (the first
    path where one tensor is reached from several). Dicts, lists, tuples
    and NamedTuples keep their structure; other leaves (a prepared
    weight's dtype tag, None) stay as they are."""
    if isinstance(tree, torch.Tensor):
        if id(tree) not in seen:
            if tree.is_inference():
                raise ValueError(
                    f"{path} is an inference tensor: build the ServingModel "
                    "outside torch.inference_mode to trace its programs")
            module.register_buffer(path, tree)
            seen[id(tree)] = _Buffer(path)
        return seen[id(tree)]
    if isinstance(tree, dict):
        return {k: _register_tree(module, v, f"{path}__{k}", seen)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_register_tree(module, v, f"{path}__{f}", seen)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_register_tree(module, v, f"{path}__{i}", seen)
                          for i, v in enumerate(tree))
    return tree


def _fill(tree, module: torch.nn.Module):
    """`_register_tree`'s skeleton with the module's buffers put back."""
    if isinstance(tree, _Buffer):
        return module.get_buffer(tree.name)
    if isinstance(tree, dict):
        return {k: _fill(v, module) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_fill(v, module) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, module) for v in tree)
    return tree


def serving_buffers(params, arch) -> Dict[str, torch.Tensor]:
    """The buffers of a serving module on these prepared trees, by name
    ("params__qst__lstm__layers__0__cell__w_ih"): a program's state."""
    module, seen = torch.nn.Module(), {}
    _register_tree(module, params, "params", seen)
    _register_tree(module, arch, "arch", seen)
    return dict(module.named_buffers())


def buffer_record(buffers: Mapping[str, torch.Tensor]) -> List[dict]:
    return [{"name": k, "dtype": _dtype_name(t), "shape": list(t.shape)}
            for k, t in buffers.items()]


def _check_buffers(buffers: Mapping[str, torch.Tensor],
                   record: List[dict]) -> None:
    got = buffer_record(buffers)
    if got == record:
        return
    names = {r["name"] for r in record}
    missing = sorted(names - set(buffers))
    extra = sorted(set(buffers) - names)
    if missing or extra:
        raise ValueError(f"the prepared weights' buffers are not the "
                         f"programs': missing {missing[:3]}, unexpected "
                         f"{extra[:3]}")
    want = {r["name"]: r for r in record}
    bad = next(g for g in got if g != want[g["name"]])
    raise ValueError(f"buffer {bad['name']} is {bad['dtype']} "
                     f"{bad['shape']} where the programs take "
                     f"{want[bad['name']]['dtype']} "
                     f"{want[bad['name']]['shape']}")


# ---------------------------------------------------------------------------
# torch.export's serialization (private APIs; what differs between
# PyTorch versions stays in the three functions below)
# ---------------------------------------------------------------------------

_SERDE_LOCK = threading.Lock()


@contextlib.contextmanager
def _lean_serde(serde):
    """torch.export's serializer module without three costs that leave
    its results as they are: the canonical form that `serialize` computes
    on a deep copy of the graph as a self-check and discards (most of
    the serialization), `typing.get_type_hints` of the same schema
    classes again for every node while the JSON is parsed (most of the
    parse), and sympy's parse of the same shape expression again for
    every tensor while the graph is rebuilt, kept for the same names in
    scope. Module-wide while open, so one at a time; a PyTorch without
    them runs as it is."""
    hints: Dict[Any, Any] = {}
    exprs: Dict[Any, Any] = {}

    def get_type_hints(cls, globalns=None, **kwargs):
        key = (cls, id(globalns))
        if key not in hints:
            hints[key] = typing.get_type_hints(cls, globalns=globalns,
                                               **kwargs)
        return hints[key]

    def sympify(a, *args, **kwargs):
        if not isinstance(a, str) or args or set(kwargs) - {"locals"}:
            return sympy.sympify(a, *args, **kwargs)
        key = (a, tuple(sorted(kwargs.get("locals") or ())))
        if key not in exprs:
            exprs[key] = sympy.sympify(a, **kwargs)
        return exprs[key]

    lean = {"typing": types.SimpleNamespace(
                **{**vars(typing), "get_type_hints": get_type_hints}),
            "canonicalize": lambda program, *args, **kwargs: program}
    sympy = getattr(serde, "sympy", None)
    if sympy is not None:
        lean["sympy"] = types.SimpleNamespace(
            **{**vars(sympy), "sympify": sympify})
    with _SERDE_LOCK:
        saved = {k: getattr(serde, k) for k in lean if hasattr(serde, k)}
        try:
            for k in saved:
                setattr(serde, k, lean[k])
            yield
        finally:
            for k, v in saved.items():
                setattr(serde, k, v)


def program_files(program) -> Dict[str, Any]:
    """A `torch.export` program -> {"program": its graph as the JSON bytes
    of torch.export's schema (`serialize(ep).exported_program`),
    "constants": its lifted constants}. The weights (its state_dict), the
    constants and the example inputs are not pickled where this PyTorch
    can skip them, and are dropped where it cannot."""
    from torch._export.serde import serialize as serde

    skip = {k: False for k in ("serialize_state_dict", "serialize_constants",
                               "serialize_example_inputs")
            if k in inspect.signature(serde.serialize).parameters}
    with _lean_serde(serde):
        blob = serde.serialize(program, **skip).exported_program
    return {"program": blob,
            "constants": {k: v.detach() for k, v in
                          program.constants.items()}}


def load_program(files: Mapping[str, Any],
                 buffers: Mapping[str, torch.Tensor],
                 device: torch.device):
    """`program_files`' output and the prepared buffers -> the
    ExportedProgram, without pickle or `torch.load`: the JSON parsed into
    torch.export's schema and deserialized with the state given as
    tensors."""
    from torch._export.serde import schema
    from torch._export.serde import serialize as serde

    constants = {k: v.to(device) for k, v in files["constants"].items()}
    with _lean_serde(serde):
        parsed = serde._dict_to_dataclass(schema.ExportedProgram,
                                          json.loads(files["program"]))
        return serde.ExportedProgramDeserializer().deserialize(
            parsed, dict(buffers), constants, None)


# ---------------------------------------------------------------------------
# the program model
# ---------------------------------------------------------------------------

def check_device(device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is "
                           "available; pass device='cpu' explicitly to "
                           "serve on the CPU")


def generated_answers(family: str, meta: Mapping[str, Any], out) -> List[str]:
    """Answer strings of a `generate` output: a unified stream's words
    strictly between `<sep>` and `<end>`, or the answer vocabulary's word
    of the EF's answer to its own question (the vocabularies come from
    the artifact's meta)."""
    key = "unified_words" if family == "unified" else "ans_words"
    words = meta.get(key)
    if not words:
        raise ValueError(f"artifact was exported without its "
                         f"vocabularies; no {key} embedded")
    if family == "unified":
        return [extract_answer_words([words[int(i)] for i in row])
                for row in out.cpu().numpy()]
    return [words[int(i)] for i in out[1].cpu().numpy()]


class ProgramModel:
    """An artifact's programs for one device, with ServingModel's surface
    (`meta`, `family`, `functions`, `device`, `answer_logits`,
    `generate`, `generated_answers`) and none of the model code: the
    programs run on buffers rebuilt from the artifact's params for the
    recorded compute dtype and flags. `device` defaults to "cuda" and
    there is no fallback. Raises where the artifact holds no programs
    for the device's platform, where a rebuilt buffer's name, dtype or
    shape is not the recorded one, and on a batch above the recorded
    `max_batch`. A derived network needs no genotype: it is in the
    graph."""

    def __init__(self, artifact: Dict[str, Any],
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        check_device(self.device)
        meta = artifact["meta"]
        family = meta.get("family")
        if family not in FUNCTIONS:
            raise ValueError(f"unknown artifact family {family!r}")
        records = meta.get("torch_programs") or {}
        platform = self.device.type
        if platform not in records:
            raise ValueError(
                f"the artifact holds no torch.export programs for "
                f"{platform}; it has programs for {sorted(records)} (export "
                f"it with --platforms {platform})")
        rec = records[platform]
        self.meta, self.family, self.record = meta, family, rec
        self.max_batch = int(rec["max_batch"])
        dtype = N.torch_dtype(rec["compute_dtype"])
        params, arch = prepare_serving_tree(
            artifact["params"]["params"], artifact["params"].get("arch"),
            family, dtype, rec["flags"], self.device)
        buffers = serving_buffers(params, arch)
        _check_buffers(buffers, rec["buffers"])
        files = artifact[PROGRAMS_DIR][platform]
        self._programs = {name: load_program(files[name], buffers,
                                             self.device).module()
                          for name in rec["functions"]}
        # the eager fp32 convolution's switch, which a program does not hold
        self._exact = dtype == torch.float32

    @property
    def functions(self):
        """The family's functions that the artifact holds programs of."""
        return [f for f in FUNCTIONS[self.family] if f in self._programs]

    def _tensor(self, a, dtype) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return t.to(self.device, dtype)

    def _call(self, name: str, *arrays):
        if name not in self._programs:
            raise ValueError(f"the artifact holds no {name} program")
        args = [self._tensor(a, dt)
                for a, dt in zip(arrays, (torch.uint8, torch.int32))]
        b = args[0].shape[0]
        if not 1 <= b <= self.max_batch:
            raise ValueError(f"a batch of {b}: the programs take 1 to "
                             f"{self.max_batch} rows (export --max_batch)")
        with torch.inference_mode(), (
                _no_tf32() if self._exact else contextlib.nullcontext()):
            return self._programs[name](*args)

    def answer_logits(self, u8_images, qst_ids) -> torch.Tensor:
        """uint8 [B, S, S, 3] and int [B, T] -> fp32 logits [B, A]."""
        if "answer_logits" not in self.functions:
            raise ValueError(f"{self.family} artifacts have no "
                             "answer_logits function")
        return self._call("answer_logits", u8_images, qst_ids)

    def generate(self, u8_images):
        """uint8 [B, S, S, 3] -> EF: (greedy question tokens int32 [B, T],
        answer ids [B]); unified: the greedy `<start> q <sep> a <end>`
        stream, int32 [B, T]."""
        if self.family == "w":
            raise ValueError("W-model artifacts have no generate function")
        return self._call("generate", u8_images)

    def generated_answers(self, u8_images) -> List[str]:
        return generated_answers(self.family, self.meta,
                                 self.generate(u8_images))


def load_programs(path: str,
                  device: Union[str, torch.device] = "cuda") -> ProgramModel:
    return ProgramModel(read_artifact(path), device)
