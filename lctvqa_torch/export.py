"""Artifacts and the serving model (counterpart of lctvqa/export.py's
`export_state`, `save_artifact`, `read_artifact`, `ServingModel` and
`load_artifact`).

An artifact is one ZIP file (no pickle): `meta.json`, `tree.json` (the
param tree's skeleton and the leaves' dtypes and shapes), `leaves/<i>`
(raw little-endian bytes) and `exported/<name>` (the JAX package's
StableHLO programs, which the port carries through and never runs). The
format is the JAX package's, so either package reads what the other
wrote. Params inside are in the JAX layout (`convert.to_jax`).

`ServingModel` runs the port's own model code, with its CUDA kernels, on
an artifact's params. Model dimensions come from the param shapes and
`meta`, so a reduced-size artifact needs no flags; the compute dtype and
the kernel flags come from `ModelConfig`'s defaults (bf16 operands, the
LSTM cell kernel on) unless the caller overrides them.

Served: W artifacts (`answer_logits`), EF artifacts with the fixed
VGG19 encoder, the PC-DARTS supernet or a derived network
(`answer_logits`, `generate`), and unified artifacts (`generate`: the
greedy `<start> q <sep> a <end>` stream alone; `generated_answers` reads
the answer out of it), each fp or int8 (`quant.py`: "w_q" leaves, which
the weight preparation at load leaves int8), whichever package wrote
it. The supernet's arch parameters ride in the bundle. A derived
network's genotype does not: the JAX package writes it only into its
StableHLO programs, so the caller names it (`load_artifact(path,
genotype=...)`, serve's `--genotype`: a preset, a search checkpoint or a
repr file), and a genotype whose network does not have the artifact's
param shapes raises.

`export_state` makes an artifact of a checkpoint's trees, recognizing
the family as the JAX package's does (a DARTS-family `vqa_model.ckpt` is
an EF model, or a unified one where its params hold "qa"), int8 with
`int8=True`; it writes no programs. The CLI,

    python -m lctvqa_torch.export --exp E --model ef|w|vqa [--int8] \
        [--input_dir D] [--out F] [--check] [--device cuda|cpu]

reads a checkpoint of either package from `<root_stats_dir>/E` (for
`vqa` with its `arch_par.ckpt` where there is one), writes the artifact
and, with `--check`, reloads it through `ServingModel` and holds it
against the model functions applied to the checkpoint's trees.

`export_programs` traces a ServingModel's serving functions into
`torch.export` programs (step 1 of ROADMAP.md queue 1 item 6b): a
symbolic batch, the JAX programs' uint8 and int32 inputs, the weights as
the program's buffers, and each serving kernel a `lctvqa_torch::`
operator of the graph (`ops/_build.py::define_op`). The programs are not
yet written into the artifact, and int8 models and fp32 models on the
card are not traced (step 2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import zipfile
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence,
                    Union)

import numpy as np
import torch

from lctvqa_torch import convert
from lctvqa_torch.config import ModelConfig
from lctvqa_torch.data.pipeline import normalize_images
from lctvqa_torch.models import (derived, search, unified as unified_model,
                                 vqa_ef, vqa_w)
from lctvqa_torch.models.genotypes import Genotype
from lctvqa_torch.ops import cuda_generate
from lctvqa_torch.ops import nn as N
from lctvqa_torch.ops.cuda_lstm import cell_weights
from lctvqa_torch.ops.cuda_mixedop import node_weights
from lctvqa_torch.quant import quantize_model
from lctvqa_torch.text import VocabDict, extract_answer_words

ARTIFACT_VERSION = 1


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


def save_artifact(artifact: Dict[str, Any], path: str) -> None:
    """Write {"exported", "params", "meta"} as the ZIP described above.
    `params` is a tree of numpy arrays in the JAX layout."""
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
    os.replace(tmp, path)


def read_artifact(path: str, trusted: bool = False) -> Dict[str, Any]:
    """Read an artifact file -> artifact dict. ZIP artifacts (the current
    format) load with no code execution; legacy pickle artifacts require
    trusted=True (serve CLI: --trusted)."""
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
    return {"exported": exported, "params": params, "meta": meta}


# ---------------------------------------------------------------------------
# the serving model
# ---------------------------------------------------------------------------

FUNCTIONS = {"w": ("answer_logits",), "ef": ("answer_logits", "generate"),
             "unified": ("generate",)}


def _read_vocab(input_dir: Optional[str]) -> Dict[str, Any]:
    """The word lists of `input_dir`'s vocabulary files that exist."""
    out = {}
    for key, fname in (("qst_words", "vocab_questions.txt"),
                       ("ans_words", "vocab_answers.txt"),
                       ("unified_words", "vocab_unified.txt")):
        path = os.path.join(input_dir or "", fname)
        if input_dir and os.path.exists(path):
            out[key] = VocabDict(path).word_list
    return out


def export_state(state: Dict[str, Any], mcfg: ModelConfig,
                 input_dir: Optional[str] = None,
                 int8: bool = False) -> Dict[str, Any]:
    """A checkpoint's trees in the port's layout (tensors, or a port
    checkpoint as `checkpoint.load_state` returns it) -> an artifact dict
    for `save_artifact`, with no programs under "exported" (the JAX
    package's StableHLO is not written here). `state` is an
    `ef_model.ckpt` ({"ef_params", "arch", ...}), a `w_model.ckpt`
    ({"w_params", ...}) or a DARTS-family `vqa_model.ckpt` ({"params",
    ...}, with "arch" from `arch_par.ckpt`): a unified model where its
    params hold "qa", an EF model otherwise. `mcfg` is the config it was
    trained with; `input_dir`'s vocabularies go into meta, and one whose
    size is not the model's raises. `int8` quantizes the params
    (`quant.quantize_model`); the supernet raises, as in the JAX
    package."""
    if "w_params" in state:
        family, params = "w", state["w_params"]
    elif "ef_params" in state:
        family, params = "ef", state["ef_params"]
    else:
        params = state["params"]
        family = "unified" if "qa" in params else "ef"
    arch = None if family == "w" else state.get("arch")
    params = convert.as_tensors(params)
    if int8:
        if mcfg.arch_type == "darts" and family != "w":
            raise ValueError(
                "--int8 cannot serve the darts supernet; decode a genotype "
                "and retrain with --arch_type derived first")
        params = quantize_model(params)
    bundle = {"params": convert.to_jax(params)}
    if arch is not None:
        bundle["arch"] = convert.to_jax(convert.as_tensors(arch))
    from lctvqa_torch import __version__
    meta = {"artifact_version": ARTIFACT_VERSION, "family": family,
            "int8": bool(int8), "platforms": ["cuda"],
            "img_size": mcfg.img_size, "max_qst_len": mcfg.max_qst_len,
            "qst_vocab_size": mcfg.qst_vocab_size,
            "ans_vocab_size": mcfg.ans_vocab_size,
            "arch_type": mcfg.arch_type, "epoch": state.get("epoch"),
            "lctvqa_version": __version__}
    vocab = _read_vocab(input_dir)
    checks = ((("unified_words", "qst_vocab_size"),) if family == "unified"
              else (("qst_words", "qst_vocab_size"),
                    ("ans_words", "ans_vocab_size")))
    for key, size_key in checks:
        words = vocab.get(key)
        if words is not None and len(words) != meta[size_key]:
            raise ValueError(f"input_dir vocab mismatch: {key} has "
                             f"{len(words)} entries but the model's "
                             f"{size_key} is {meta[size_key]}")
    meta.update(vocab)
    return {"exported": {}, "params": bundle, "meta": meta}


def _w(p):
    """A conv's or linear's weight of either form (fp "w", int8 "w_q"),
    for its shape."""
    return p["w"] if "w" in p else p["w_q"]


def _darts_dims(params) -> Dict[str, int]:
    """The supernet's dims from its param shapes (JAX layout: convs HWIO)."""
    cells = params["darts"]["cells"]
    n_cells = len(cells)
    c_first = cells[0]["pre1"]["conv"]["w"].shape[3]
    c_last = cells[-1]["pre1"]["conv"]["w"].shape[3]
    # cell 0 doubles its width when it is a reduction cell (under 3 layers)
    first_reduces = 0 in (n_cells // 3, 2 * n_cells // 3)
    init_ch = c_first // 2 if first_reduces else c_first
    n_ops = len(cells[0]["ops"])
    steps = next(s for s in range(1, n_ops + 1)
                 if search.num_edges(s) >= n_ops)
    if search.num_edges(steps) != n_ops:
        raise ValueError(f"a cell with {n_ops} edges fits no darts_steps")
    c_slice = cells[0]["ops"][0]["dil_conv_3x3"]["dw"]["w"].shape[3]
    return dict(
        darts_layers=n_cells, darts_init_ch=init_ch, darts_steps=steps,
        darts_stem_multiplier=(params["darts"]["stem_conv"]["w"].shape[3]
                               // init_ch),
        darts_partial_k=c_first // c_slice,
        darts_multiplier=params["img_fc"]["w"].shape[0] // (
            search.OUTPUT_SIZE * search.OUTPUT_SIZE * c_last))


def _shapes(tree, path=""):
    """(path, shape) of every leaf of a param tree; an int8 weight
    ("w_q") stands for the weight of its shape, its scales are left
    out."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k != "w_s":
                yield from _shapes(v, f"{path}/{'w' if k == 'w_q' else k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _shapes(v, f"{path}/{i}")
    else:
        yield path, tuple(tree.shape)


def _derived_dims(params, genotype: Genotype) -> Dict[str, Any]:
    """A derived network's dims from its param shapes (JAX layout) and its
    genotype, which must build a network of exactly those shapes."""
    tree = params["derived"]
    cells = tree["cells"]
    n_cells = len(cells)
    c_first = _w(cells[0]["pre1"]["conv"]).shape[3]
    first_reduces = 0 in (n_cells // 3, 2 * n_cells // 3)
    init_ch = c_first // 2 if first_reduces else c_first
    dims = dict(arch_type="derived", genotype=genotype, darts_layers=n_cells,
                darts_init_ch=init_ch,
                darts_stem_multiplier=_w(tree["stem_conv"]).shape[3]
                // init_ch,
                darts_steps=len(genotype.normal) // 2,
                darts_multiplier=len(genotype.normal_concat))
    got = dict(_shapes(tree))
    want = dict(_shapes(convert.to_jax(derived.derived_network_init(
        torch.Generator(), dataclasses.replace(ModelConfig(), **dims),
        genotype))))
    if got != want:
        where = next((f"{p}: {got.get(p)} in the artifact, {want.get(p)} "
                      "from the genotype" for p in sorted({*got, *want})
                      if got.get(p) != want.get(p)))
        raise ValueError(f"the genotype {genotype} builds another network "
                         f"than the artifact's derived params ({where})")
    return dims


def model_config(meta: Dict[str, Any], params, genotype=None,
                 **overrides) -> ModelConfig:
    """ModelConfig of an artifact: dims from the param shapes and meta
    (and a derived network's `genotype`), everything else from
    ModelConfig's defaults and `overrides`. A unified tree's stream
    model is `params["qa"]`, whose vocabulary is the unified one; it has
    no answer head, and meta gives the answer vocabulary's size."""
    qst = params["qa"] if "qa" in params else params["qst"]
    layers = qst["lstm"]["layers"]
    vocab, word_embed = qst["word2vec"]["table"].shape
    if "darts" in params:
        encoder = dict(arch_type="darts", **_darts_dims(params))
    elif "derived" in params:
        vqa_ef.check_arch_type("derived", genotype)
        encoder = _derived_dims(params, genotype)
    else:
        encoder = dict(arch_type="fixed",
                       vgg_fc_dim=_w(params["vgg"]["fc7"]).shape[1])
    return dataclasses.replace(
        ModelConfig(),
        img_embed_size=_w(params["img_fc"]).shape[1],
        word_embed_size=word_embed,
        lstm_hidden_size=layers[0]["w_hh"].shape[0],
        lstm_num_layers=len(layers),
        max_qst_len=meta["max_qst_len"],
        qst_vocab_size=vocab,
        ans_vocab_size=(_w(params["fc2"]).shape[1] if "fc2" in params
                        else meta["ans_vocab_size"]),
        img_size=meta["img_size"],
        **encoder, **overrides)


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


def answer_logits(family: str, config: ModelConfig, params, arch,
                  u8: torch.Tensor, qst: torch.Tensor) -> torch.Tensor:
    """The served `answer_logits` on a prepared tree: uint8 images [B, S,
    S, 3] and integer question ids [B, T] on the params' device -> fp32
    logits [B, A]. Normalization and the cast of the ids to int64 happen
    here, so that a traced program takes the JAX programs' inputs."""
    img = normalize_images(u8)
    qst = qst.to(torch.int64)
    if family == "w":
        return vqa_w.w_forward(params, config, img, qst)
    logits, _ = vqa_ef.ef_forward(params, arch, config, img, qst)
    return logits


def generate(family: str, config: ModelConfig, params, arch,
             u8: torch.Tensor):
    """The served `generate` on a prepared tree: uint8 images -> EF:
    (greedy question tokens int32 [B, T], answer ids int64 [B]); unified:
    the greedy stream, int32 [B, T]."""
    img = normalize_images(u8)
    if family == "unified":
        return unified_model.unified_generate(params, arch, config, img)
    qst, ans = vqa_ef.ef_generate(params, arch, config, img)
    return qst, torch.argmax(ans, dim=1)


class ServingModel:
    """A loaded artifact on one device: params as tensors plus the model
    functions. `device` defaults to "cuda" and there is no fallback: on a
    host without a GPU, pass device="cpu" explicitly (the CPU runs the
    kernels' plain versions).

    Config overrides (`compute_dtype`, `use_pallas_lstm`,
    `pallas_seq_lstm`, `pallas_generate`, `pallas_mixed_op`) pick the
    numerics and the kernels. The weights are cast for the compute dtype
    and packed for the kernels once, here. `genotype` (a Genotype, or a
    preset name, search checkpoint or repr file that resolve_genotype
    reads) is a derived network's, which the artifact does not carry.

    A supernet's BatchNorm is batch-statistics (no artifact carries
    running statistics), so a row's answer depends on the other rows of
    the batch it is computed in."""

    def __init__(self, artifact: Dict[str, Any],
                 device: Union[str, torch.device] = "cuda",
                 genotype: Union[None, str, Genotype] = None, **overrides):
        meta = artifact["meta"]
        family = meta.get("family")
        if family not in FUNCTIONS:
            raise ValueError(f"unknown artifact family {family!r}")
        params = artifact["params"]["params"]
        if bool(meta.get("int8")) != _has_int8(params):
            raise ValueError(
                f"artifact meta says int8={bool(meta.get('int8'))} but its "
                f"params hold {'' if _has_int8(params) else 'no '}int8 "
                "weights")
        if family != "w":
            arch_type = ("derived" if "derived" in params else
                         "darts" if "darts" in params else "fixed")
            if meta.get("arch_type", arch_type) != arch_type:
                raise ValueError(
                    f"artifact meta says arch_type={meta['arch_type']!r} "
                    f"but its params hold a {arch_type!r} encoder")
            if family == "unified":
                unified_model.check_arch_type(arch_type)
        if isinstance(genotype, str):
            from lctvqa_torch.genotype import resolve_genotype
            genotype = resolve_genotype(genotype)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is "
                               "available; pass device='cpu' explicitly to "
                               "serve on the CPU")
        self.meta = meta
        self.family = family
        self.config = model_config(meta, params, genotype, **overrides)
        dtype = N.torch_dtype(self.config.compute_dtype)
        self.params = _prepare(
            convert.from_jax(params, self.device), dtype,
            node_kernel=(self.config.pallas_mixed_op
                         and self.config.fold_bn_mixture))
        arch = artifact["params"].get("arch")
        if self.config.arch_type == "darts" and arch is None:
            raise ValueError("a darts EF artifact needs its arch parameters "
                             "under params['arch']")
        self.arch = (None if arch is None
                     else convert.from_jax(arch, self.device))
        # the decoder: the EF model's question encoder, or the unified
        # model's stream LSTM and head
        self._decoder = "qa" if family == "unified" else "qst"
        if family != "w" and self.config.pallas_generate:
            dec = self.params[self._decoder]
            dec["decode"] = cuda_generate.decode_weights(dec, dtype)

    @property
    def functions(self):
        return list(FUNCTIONS[self.family])

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    @torch.inference_mode()
    def answer_logits(self, u8_images, qst_ids) -> torch.Tensor:
        """uint8 [B, S, S, 3] and int [B, T] -> fp32 logits [B, A]."""
        if "answer_logits" not in self.functions:
            raise ValueError(f"{self.family} artifacts have no "
                             "answer_logits function")
        return answer_logits(self.family, self.config, self.params,
                             self.arch, self._tensor(u8_images, torch.uint8),
                             self._tensor(qst_ids, torch.int64))

    @torch.inference_mode()
    def generate(self, u8_images):
        """uint8 [B, S, S, 3] -> EF: (greedy question tokens int32 [B, T],
        answer ids [B]); unified: the greedy `<start> q <sep> a <end>`
        stream, int32 [B, T]."""
        if self.family == "w":
            raise ValueError("W-model artifacts have no generate function")
        return generate(self.family, self.config, self.params, self.arch,
                        self._tensor(u8_images, torch.uint8))

    def generated_answers(self, u8_images) -> List[str]:
        """Answer strings of greedy generation: a unified stream's words
        strictly between `<sep>` and `<end>`, or the answer vocabulary's
        word of the EF's answer to its own question (the vocabularies
        come from the artifact's meta)."""
        out = self.generate(u8_images)
        key = "unified_words" if self.family == "unified" else "ans_words"
        words = self.meta.get(key)
        if not words:
            raise ValueError(f"artifact was exported without its "
                             f"vocabularies; no {key} embedded")
        if self.family == "unified":
            return [extract_answer_words([words[int(i)] for i in row])
                    for row in out.cpu().numpy()]
        return [words[int(i)] for i in out[1].cpu().numpy()]


def load_artifact(path: str, device: Union[str, torch.device] = "cuda",
                  trusted: bool = False,
                  genotype: Union[None, str, Genotype] = None,
                  **overrides) -> ServingModel:
    return ServingModel(read_artifact(path, trusted=trusted), device,
                        genotype, **overrides)


# ---------------------------------------------------------------------------
# torch.export programs
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


class _ServingModule(torch.nn.Module):
    """One serving function of a ServingModel as a module whose buffers
    are the model's prepared params and arch, named by their tree paths
    ("params__qst__lstm__layers__0__cell__w_ih"), so that a program's
    state_dict carries them as the JAX programs take the params as
    arguments."""

    def __init__(self, model: "ServingModel"):
        super().__init__()
        self.family, self.config = model.family, model.config
        seen: dict = {}
        self._params = _register_tree(self, model.params, "params", seen)
        self._arch = _register_tree(self, model.arch, "arch", seen)

    def trees(self):
        return _fill(self._params, self), _fill(self._arch, self)


class _AnswerLogits(_ServingModule):
    def forward(self, u8: torch.Tensor, qst: torch.Tensor) -> torch.Tensor:
        return answer_logits(self.family, self.config, *self.trees(), u8,
                             qst)


class _Generate(_ServingModule):
    def forward(self, u8: torch.Tensor):
        return generate(self.family, self.config, *self.trees(), u8)


def export_programs(model: "ServingModel", max_batch: int = 64,
                    functions: Optional[Sequence[str]] = None
                    ) -> Dict[str, "torch.export.ExportedProgram"]:
    """Each serving function of `model` (or those named in `functions`) as
    a `torch.export` program (counterpart of lctvqa/export.py's
    `_build_fns` and its `jax.export` loop, without serializing): inputs
    the JAX programs' uint8 images [B, S, S, 3] and int32 question ids
    [B, T], the batch B symbolic from 1 to `max_batch`; the weights and
    arch the program's buffers (its state_dict). Traced under no_grad on
    the model's device, to which a program is then tied (it asserts its
    inputs' device), with the kernel flags of the model's config and the
    process-wide BatchNorm switch (`ops/conv.py::USE_PALLAS_BN`) as they
    are now: each kernel on that path is a `lctvqa_torch::` operator of
    the graph. The programs are not written into an artifact, and int8
    models and fp32 models on the card are not traced (ROADMAP.md queue 1
    item 6b, step 2)."""
    if model.meta.get("int8") or _has_int8(model.params):
        raise NotImplementedError(
            "int8 programs are ROADMAP.md queue 1 item 6b, step 2: the int8 "
            "products pad the batch with a branch on its size")
    if (model.device.type == "cuda"
            and N.torch_dtype(model.config.compute_dtype) == torch.float32):
        raise NotImplementedError(
            "fp32 programs on the card are ROADMAP.md queue 1 item 6b, step "
            "2: an fp32 convolution turns cuDNN's TF32 off around its call "
            "(ops/conv.py::_ExactConvFn), which a program does not record, "
            "so it would run at the caller's TF32 setting")
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    names = list(functions) if functions is not None else model.functions
    unknown = sorted(set(names) - set(model.functions))
    if unknown:
        raise ValueError(f"{model.family} artifacts have no {unknown}")
    s, steps = model.config.img_size, model.config.max_qst_len
    u8 = torch.zeros((2, s, s, 3), dtype=torch.uint8, device=model.device)
    qst = torch.zeros((2, steps), dtype=torch.int32, device=model.device)
    batch = torch.export.Dim("batch", min=1, max=max_batch)
    programs = {}
    # no Python stack trace kept on each node (a third of the trace time of
    # the supernet's graph); a PyTorch without the switch keeps them
    fx_config = torch.fx.config
    kept = getattr(fx_config, "do_not_emit_stack_traces", False)
    fx_config.do_not_emit_stack_traces = True
    try:
        with torch.no_grad():
            for name in names:
                if name == "answer_logits":
                    module, args = _AnswerLogits(model), (u8, qst)
                    dims = {"u8": {0: batch}, "qst": {0: batch}}
                else:
                    module, args = _Generate(model), (u8,)
                    dims = {"u8": {0: batch}}
                programs[name] = torch.export.export(
                    module, args, dynamic_shapes=dims, strict=False)
    finally:
        fx_config.do_not_emit_stack_traces = kept
    return programs


# ---------------------------------------------------------------------------
# the export CLI
# ---------------------------------------------------------------------------

# the ModelConfig fields a served model takes from the checkpoint's config
SERVING_FIELDS = ("compute_dtype", "use_pallas_lstm", "pallas_seq_lstm",
                  "pallas_generate", "pallas_mixed_op", "fold_bn_mixture")


def _agree(got, want, what: str) -> None:
    """Floats within 2e-4, ids and tokens exactly (the JAX package's
    round-trip check)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} against "
                             f"{want.shape}")
    if np.issubdtype(got.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def check_roundtrip(path: str, state: Dict[str, Any], mcfg: ModelConfig,
                    int8: bool, device: Union[str, torch.device]) -> None:
    """The artifact at `path`, reloaded through `ServingModel` on
    `device`, against the model functions applied directly to the
    checkpoint's trees in `state` (quantized as the export did), at
    batch sizes 2 and 5 (counterpart of lctvqa/export.py's
    `_check_roundtrip`). Raises AssertionError where they differ."""
    device = torch.device(device)
    model = load_artifact(
        path, device, genotype=(mcfg.genotype if mcfg.arch_type == "derived"
                                else None),
        **{f: getattr(mcfg, f) for f in SERVING_FIELDS})
    key = next(k for k in ("w_params", "ef_params", "params") if k in state)
    params = convert.as_tensors(state[key], device)
    if int8:
        params = quantize_model(params)
    arch = None if model.family == "w" else state.get("arch")
    arch = None if arch is None else convert.as_tensors(arch, device)
    rng = np.random.default_rng(0)
    s = mcfg.img_size
    with torch.inference_mode():
        for batch in (2, 5):
            u8 = rng.integers(0, 256, (batch, s, s, 3), dtype=np.uint8)
            qst = rng.integers(0, mcfg.qst_vocab_size,
                               (batch, mcfg.max_qst_len), dtype=np.int32)
            img = normalize_images(torch.from_numpy(u8).to(device))
            q = torch.from_numpy(qst).to(device, torch.int64)
            if model.family == "w":
                _agree(model.answer_logits(u8, qst),
                       vqa_w.w_forward(params, mcfg, img, q),
                       f"answer_logits at batch {batch}")
            elif model.family == "ef":
                _agree(model.answer_logits(u8, qst),
                       vqa_ef.ef_forward(params, arch, mcfg, img, q)[0],
                       f"answer_logits at batch {batch}")
                tok, ans = vqa_ef.ef_generate(params, arch, mcfg, img)
                got = model.generate(u8)
                _agree(got[0], tok, f"generate's tokens at batch {batch}")
                _agree(got[1], ans.argmax(1),
                       f"generate's answers at batch {batch}")
            else:
                _agree(model.generate(u8),
                       unified_model.unified_generate(params, arch, mcfg,
                                                      img),
                       f"generate at batch {batch}")
    print(f"check ok: {model.functions} agree at batch sizes 2 and 5 on "
          f"{device}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export an experiment's checkpoint, written by either "
        "package, as a serving artifact. The port serves the artifact's "
        "params with its own model code; export.export_programs traces them "
        "into torch.export programs (ROADMAP.md queue 1 item 6b, step 1), "
        "which are not yet written into the artifact (step 2).")
    p.add_argument("--exp", type=str, required=True)
    p.add_argument("--root_stats_dir", type=str, default="./experiment_data")
    p.add_argument("--model", type=str, default="ef",
                   choices=("ef", "w", "vqa"),
                   help="which checkpoint of the experiment to export; "
                        "'vqa' is the darts/unified families' "
                        "vqa_model.ckpt (+ arch_par.ckpt when present)")
    p.add_argument("--out", type=str, default=None,
                   help="artifact path (default <exp_dir>/<model>_serving"
                        ".lctx)")
    p.add_argument("--int8", action="store_true",
                   help="export the int8-quantized serving path "
                        "(lctvqa_torch/quant.py; not the darts supernet)")
    p.add_argument("--input_dir", type=str, default=None,
                   help="dataset dir; embeds the vocab word lists so the "
                        "server can decode answers")
    p.add_argument("--check", action="store_true",
                   help="after exporting, reload the artifact and hold it "
                        "against the model applied to the checkpoint")
    p.add_argument("--trusted", action="store_true",
                   help="the JAX package's flag for legacy pickle "
                        "checkpoints; the port reads only ZIP checkpoints "
                        "and refuses a pickle with or without it")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of --check: 'cuda' (default) or 'cpu'; "
                        "nothing falls back")
    return p


def main(argv=None) -> str:
    """-> the artifact's path."""
    args = build_parser().parse_args(argv)
    from lctvqa_torch.train import checkpoint

    exp_dir = os.path.join(args.root_stats_dir, args.exp)
    ckpt = os.path.join(exp_dir, f"{args.model}_model.ckpt")
    state = checkpoint.load_state(ckpt)
    cfg = checkpoint.config_from_state(state)
    if cfg is None:
        raise SystemExit(f"{ckpt} has no embedded config (legacy "
                         "checkpoint); re-save it with a current version")
    if args.model == "vqa":
        # darts/unified family: the arch rides in a sibling checkpoint
        ap = os.path.join(exp_dir, "arch_par.ckpt")
        if checkpoint.exists(ap):
            state = dict(state, arch=checkpoint.load_state(ap)["arch"])
    trees = dict(convert.checkpoint_params(state), epoch=state.get("epoch"))
    artifact = export_state(trees, cfg.model, input_dir=args.input_dir,
                            int8=args.int8)
    out = args.out or os.path.join(exp_dir, f"{args.model}_serving.lctx")
    save_artifact(artifact, out)
    meta = artifact["meta"]
    print(f"exported {meta['family']} artifact {FUNCTIONS[meta['family']]} "
          f"-> {out} ({os.path.getsize(out)} bytes; int8={args.int8}; no "
          "torch.export programs)")
    if args.check:
        check_roundtrip(out, trees, cfg.model, args.int8, args.device)
    return out


if __name__ == "__main__":
    main()
