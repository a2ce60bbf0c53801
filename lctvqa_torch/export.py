"""Artifacts and the serving model (counterpart of lctvqa/export.py's
`export_state`, `save_artifact`, `read_artifact`, `ServingModel` and
`load_artifact`).

The artifact file (`save_artifact`, `read_artifact`; one ZIP, no
pickle, the JAX package's format with the port's programs beside it)
and the program loader live in `programs.py`, which needs none of the
model code; this module re-exports the file layer. Params inside are in
the JAX layout (`convert.to_jax`).

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
StableHLO programs, and the port only into its own, so the model code
needs it named (`load_artifact(path, genotype=...)`, serve's
`--genotype`: a preset, a search checkpoint or a repr file), and a
genotype whose network does not have the artifact's param shapes
raises. `programs.load_programs` serves an artifact's programs with no
genotype.

`export_state` makes an artifact of a checkpoint's trees, recognizing
the family as the JAX package's does (a DARTS-family `vqa_model.ckpt` is
an EF model, or a unified one where its params hold "qa"), int8 with
`int8=True`, and with `platforms=("cuda", "cpu")` (either or both) the
serving functions traced on each platform by `export_programs` into the
artifact (`torch_exported/<platform>/<name>/`, the layout in
`programs.py`); the default writes none, and the file is the one the
JAX package would write. The CLI,

    python -m lctvqa_torch.export --exp E --model ef|w|vqa [--int8] \
        [--input_dir D] [--out F] [--platforms cuda,cpu] \
        [--max_batch 64] [--check] [--device cuda|cpu]

reads a checkpoint of either package from `<root_stats_dir>/E` (for
`vqa` with its `arch_par.ckpt` where there is one), writes the artifact
and, with `--check`, reloads it through `ServingModel` and holds it
against the model functions applied to the checkpoint's trees, then,
where it holds programs for `--device`'s platform, reloads those with
`programs.load_programs` and holds them against the ServingModel.

`export_programs` traces a ServingModel's serving functions into
`torch.export` programs: a symbolic batch, the JAX programs' uint8 and
int32 inputs, the weights as the program's buffers, and each serving
kernel a `lctvqa_torch::` operator of the graph
(`ops/_build.py::define_op`); an int8 product is `aten._int_mm` on the
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from lctvqa_torch import convert, programs as P
from lctvqa_torch.config import ModelConfig
from lctvqa_torch.data.pipeline import normalize_images
from lctvqa_torch.models import (derived, search, unified as unified_model,
                                 vqa_ef, vqa_w)
from lctvqa_torch.models.genotypes import Genotype
from lctvqa_torch.ops import conv
from lctvqa_torch.ops import nn as N
from lctvqa_torch.programs import (  # noqa: F401 (re-exported)
    ARTIFACT_VERSION, FUNCTIONS, SERVING_FIELDS, _Buffer, _fill, _has_int8,
    _np_dtype, _prepare, _register_tree, _skeleton_to_tree,
    _tree_to_skeleton, prepare_serving_tree, read_artifact, save_artifact)
from lctvqa_torch.quant import quantize_model
from lctvqa_torch.text import VocabDict, extract_answer_words  # noqa: F401
from lctvqa_torch.trace import span

# ---------------------------------------------------------------------------
# the serving model
# ---------------------------------------------------------------------------

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
                 input_dir: Optional[str] = None, int8: bool = False,
                 platforms: Sequence[str] = (),
                 max_batch: int = 64) -> Dict[str, Any]:
    """A checkpoint's trees in the port's layout (tensors, or a port
    checkpoint as `checkpoint.load_state` returns it) -> an artifact dict
    for `save_artifact`, with no programs under "exported" (the JAX
    package's StableHLO is not written here) and, for each of
    `platforms`, the port's programs (`add_programs`). `state` is an
    `ef_model.ckpt` ({"ef_params", "arch", ...}), a `w_model.ckpt`
    ({"w_params", ...}) or a DARTS-family `vqa_model.ckpt` ({"params",
    ...}, with "arch" from `arch_par.ckpt`): a unified model where its
    params hold "qa", an EF model otherwise. `mcfg` is the config it was
    trained with; `input_dir`'s vocabularies go into meta, and one whose
    size is not the model's raises. `int8` quantizes the params
    (`quant.quantize_model`); the supernet raises, as in the JAX
    package. Without `platforms` the dict is the one the JAX package
    would write, with no "torch_exported" and no "torch_programs" in
    meta."""
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
    artifact = {"exported": {}, "params": bundle, "meta": meta}
    if platforms:
        add_programs(artifact, mcfg, platforms, max_batch)
    return artifact


def add_programs(artifact: Dict[str, Any], mcfg: ModelConfig,
                 platforms: Sequence[str], max_batch: int = 64) -> None:
    """Trace every serving function of `artifact` on each of `platforms`
    ("cuda", "cpu") and put the programs under artifact["torch_exported"]
    and their records under meta["torch_programs"] (`programs.py`). Each
    platform's ServingModel takes the compute dtype and kernel flags of
    `mcfg` (SERVING_FIELDS) and a derived network's genotype; the
    BatchNorm kernel switch is the process's (`ops/conv.py`). "cuda" on a
    host without a card raises; nothing falls back."""
    unknown = sorted(set(platforms) - set(P.PLATFORMS))
    if unknown:
        raise ValueError(f"platforms {list(platforms)}: each must be one "
                         f"of {P.PLATFORMS}")
    genotype = mcfg.genotype if mcfg.arch_type == "derived" else None
    flags = {f: getattr(mcfg, f) for f in SERVING_FIELDS}
    files, records = {}, {}
    for platform in dict.fromkeys(platforms):
        model = ServingModel(artifact, platform, genotype, **flags)
        files[platform], records[platform] = program_entry(
            model, export_programs(model, max_batch), max_batch)
        del model
    artifact[P.PROGRAMS_DIR] = files
    artifact["meta"]["torch_programs"] = records


def program_entry(model: "ServingModel", traced: Dict[str, Any],
                  max_batch: int):
    """`model`'s programs `traced` (export_programs, on the model's device)
    -> (their files, their record): what an artifact holds for the
    model's platform under "torch_exported" and meta["torch_programs"]
    (`programs.py`)."""
    buffers = P.serving_buffers(model.params, model.arch)
    for name, program in traced.items():
        if set(program.state_dict) != set(buffers):
            raise AssertionError(f"{name}'s state is not the serving "
                                 "buffers")
    record = {
        "functions": sorted(traced),
        "compute_dtype": model.config.compute_dtype,
        "flags": {f: getattr(model.config, f) for f in SERVING_FIELDS
                  if f != "compute_dtype"},
        "batchnorm_kernel": conv.USE_PALLAS_BN, "max_batch": max_batch,
        "torch_version": torch.__version__,
        "buffers": P.buffer_record(buffers)}
    return ({name: P.program_files(program)
             for name, program in traced.items()}, record)


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
    genotype, which must build a network of exactly those shapes. The
    skeleton is told by the tree: the ImageNet one has `stem0` and
    `stem1` where the search one has `stem_conv`."""
    tree = params["derived"]
    cells = tree["cells"]
    n_cells = len(cells)
    c_first = _w(cells[0]["pre1"]["conv"]).shape[3]
    first_reduces = 0 in (n_cells // 3, 2 * n_cells // 3)
    init_ch = c_first // 2 if first_reduces else c_first
    dims = dict(arch_type="derived", genotype=genotype, darts_layers=n_cells,
                darts_init_ch=init_ch,
                darts_steps=len(genotype.normal) // 2,
                darts_multiplier=len(genotype.normal_concat))
    if "stem0" in tree:
        dims["derived_skeleton"] = "imagenet"
    else:
        dims["darts_stem_multiplier"] = (_w(tree["stem_conv"]).shape[3]
                                         // init_ch)
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
    and packed for the kernels once, here (`programs.
    prepare_serving_tree`). `genotype` (a Genotype, or a preset name,
    search checkpoint or repr file that resolve_genotype reads) is a
    derived network's, which the artifact's params do not carry
    (`programs.load_programs` serves its programs without one).

    A supernet's BatchNorm is batch-statistics (no artifact carries
    running statistics), so a row's answer depends on the other rows of
    the batch it is computed in.

    `answer_logits` and `generate` are the spans `serve.answer_logits`
    and `serve.generate`, each input's host-to-device conversion
    `serve.input` (`trace.py`), all outside the functions that
    `export_programs` traces."""

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
        P.check_device(self.device)
        self.meta = meta
        self.family = family
        self.config = model_config(meta, params, genotype, **overrides)
        arch = artifact["params"].get("arch")
        if self.config.arch_type == "darts" and arch is None:
            raise ValueError("a darts EF artifact needs its arch parameters "
                             "under params['arch']")
        self.params, self.arch = prepare_serving_tree(
            params, arch, family, N.torch_dtype(self.config.compute_dtype),
            {f: getattr(self.config, f) for f in SERVING_FIELDS},
            self.device)

    @property
    def functions(self):
        return list(FUNCTIONS[self.family])

    def _tensor(self, a, dtype) -> torch.Tensor:
        with span("serve.input"):
            return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    @torch.inference_mode()
    def answer_logits(self, u8_images, qst_ids) -> torch.Tensor:
        """uint8 [B, S, S, 3] and int [B, T] -> fp32 logits [B, A]."""
        if "answer_logits" not in self.functions:
            raise ValueError(f"{self.family} artifacts have no "
                             "answer_logits function")
        with span("serve.answer_logits"):
            return answer_logits(self.family, self.config, self.params,
                                 self.arch,
                                 self._tensor(u8_images, torch.uint8),
                                 self._tensor(qst_ids, torch.int64))

    @torch.inference_mode()
    def generate(self, u8_images):
        """uint8 [B, S, S, 3] -> EF: (greedy question tokens int32 [B, T],
        answer ids [B]); unified: the greedy `<start> q <sep> a <end>`
        stream, int32 [B, T]."""
        if self.family == "w":
            raise ValueError("W-model artifacts have no generate function")
        with span("serve.generate"):
            return generate(self.family, self.config, self.params,
                            self.arch, self._tensor(u8_images, torch.uint8))

    def generated_answers(self, u8_images) -> List[str]:
        """Answer strings of greedy generation (`programs.
        generated_answers`)."""
        return P.generated_answers(self.family, self.meta,
                                   self.generate(u8_images))


def load_artifact(path: str, device: Union[str, torch.device] = "cuda",
                  trusted: bool = False,
                  genotype: Union[None, str, Genotype] = None,
                  **overrides) -> ServingModel:
    return ServingModel(read_artifact(path, trusted=trusted), device,
                        genotype, **overrides)


# ---------------------------------------------------------------------------
# torch.export programs
# ---------------------------------------------------------------------------

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
    the graph, each int8 product on the card `aten._int_mm` on operands
    padded without a branch on the batch (`ops/int8.py::int8_matmul`).
    An fp32 program's convolutions follow cuDNN's TF32 switch at call
    time, which `programs.ProgramModel` turns off around each call, as
    the eager fp32 convolution does (`ops/conv.py::_ExactConvFn`).
    `programs.program_files` serializes a program for the artifact."""
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
                    int8: bool, device: Union[str, torch.device]
                    ) -> "ServingModel":
    """The artifact at `path`, reloaded through `ServingModel` on
    `device`, against the model functions applied directly to the
    checkpoint's trees in `state` (quantized as the export did), at
    batch sizes 2 and 5 (counterpart of lctvqa/export.py's
    `_check_roundtrip`). Raises AssertionError where they differ;
    returns the reloaded model."""
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
    return model


def check_programs(path: str, model: "ServingModel") -> None:
    """The artifact's programs for the platform of `model` (the eager
    ServingModel of the same artifact), reloaded through
    `programs.load_programs`, against `model` at batch sizes 2 and 5:
    tokens and ids exactly, floats through `_agree` (the programs run the
    eager call's kernels on its inputs, so they are expected to equal it
    bit for bit). Raises AssertionError where they differ."""
    device = model.device
    t0 = time.perf_counter()
    prog = P.load_programs(path, device)
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    s, steps = model.config.img_size, model.config.max_qst_len
    for batch in (2, 5):
        u8 = rng.integers(0, 256, (batch, s, s, 3), dtype=np.uint8)
        qst = rng.integers(0, model.config.qst_vocab_size, (batch, steps),
                           dtype=np.int32)
        for fn in model.functions:
            args = (u8, qst) if fn == "answer_logits" else (u8,)
            got, want = getattr(prog, fn)(*args), getattr(model, fn)(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for i, (g, w) in enumerate(zip(got, want, strict=True)):
                _agree(g, w, f"program {fn} output {i} at batch {batch}")
    print(f"check ok: the {device.type} programs {prog.functions} (loaded "
          f"in {load_s:.1f} s) agree with the model at batch sizes 2 and 5")


def program_bytes(path: str) -> Dict[str, int]:
    """Bytes each platform's programs add to the artifact file."""
    import zipfile

    out: Dict[str, int] = {}
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            parts = info.filename.split("/")
            if parts[0] == P.PROGRAMS_DIR:
                out[parts[1]] = out.get(parts[1], 0) + info.compress_size
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export an experiment's checkpoint, written by either "
        "package, as a serving artifact: its params, and with --platforms "
        "its serving functions as torch.export programs, which `python -m "
        "lctvqa_torch.serve --programs` runs without the model code.")
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
    p.add_argument("--platforms", type=str, default="",
                   help="comma-separated: 'cuda', 'cpu' or both; trace the "
                        "serving functions on each (a program runs only on "
                        "the platform it was traced on; 'cuda' needs a "
                        "card) into the artifact. Default: no programs, "
                        "the artifact the JAX package would write")
    p.add_argument("--max_batch", type=int, default=64,
                   help="the largest batch the programs take (a server's "
                        "largest bucket must not exceed it)")
    p.add_argument("--check", action="store_true",
                   help="after exporting, reload the artifact and hold it "
                        "against the model applied to the checkpoint, and "
                        "its programs for --device's platform against the "
                        "reloaded model")
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
    parser = build_parser()
    args = parser.parse_args(argv)
    platforms = tuple(p for p in args.platforms.split(",") if p)
    if args.check and platforms and (torch.device(args.device).type
                                     not in platforms):
        parser.error(f"--check runs on --device {args.device}, for which "
                     f"--platforms {args.platforms} writes no programs")
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
    t0 = time.perf_counter()
    artifact = export_state(trees, cfg.model, input_dir=args.input_dir,
                            int8=args.int8, platforms=platforms,
                            max_batch=args.max_batch)
    trace_s = time.perf_counter() - t0
    out = args.out or os.path.join(exp_dir, f"{args.model}_serving.lctx")
    save_artifact(artifact, out)
    family = artifact["meta"]["family"]
    del artifact
    sizes = program_bytes(out)
    progs = ("; ".join(f"{p} programs {n} bytes" for p, n in sizes.items())
             + f", traced in {trace_s:.1f} s" if sizes
             else "no torch.export programs")
    print(f"exported {family} artifact {FUNCTIONS[family]} -> {out} "
          f"({os.path.getsize(out)} bytes; int8={args.int8}; {progs})")
    if args.check:
        model = check_roundtrip(out, trees, cfg.model, args.int8,
                                args.device)
        if platforms:
            check_programs(out, model)
    return out


if __name__ == "__main__":
    main()
