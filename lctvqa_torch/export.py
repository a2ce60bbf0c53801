"""Artifacts and the serving model (counterpart of lctvqa/export.py's
`save_artifact`, `read_artifact`, `ServingModel` and `load_artifact`).

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

Served: W artifacts (`answer_logits`) and EF artifacts with the fixed
VGG19 encoder or the PC-DARTS supernet (`answer_logits`, `generate`;
the supernet's arch parameters ride in the bundle). int8 artifacts, EF
artifacts with a derived encoder and unified artifacts raise. Writing
`torch.export` programs is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import zipfile
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from lctvqa_torch import convert
from lctvqa_torch.config import ModelConfig
from lctvqa_torch.data.pipeline import normalize_images
from lctvqa_torch.models import search, vqa_ef, vqa_w
from lctvqa_torch.ops import cuda_generate
from lctvqa_torch.ops import nn as N
from lctvqa_torch.ops.cuda_lstm import cell_weights
from lctvqa_torch.ops.cuda_mixedop import node_weights

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


def extract_answer_words(words) -> str:
    """Words strictly between <sep> and <end> of a decoded unified QA
    stream."""
    ans, in_ans = [], False
    for w in words:
        if w == "<sep>":
            in_ans = True
        elif w == "<end>":
            break
        elif in_ans:
            ans.append(w)
    return " ".join(ans)


# ---------------------------------------------------------------------------
# the serving model
# ---------------------------------------------------------------------------

FUNCTIONS = {"w": ("answer_logits",), "ef": ("answer_logits", "generate")}


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


def model_config(meta: Dict[str, Any], params, **overrides) -> ModelConfig:
    """ModelConfig of an artifact: dims from the param shapes and meta,
    everything else from ModelConfig's defaults and `overrides`."""
    qst = params["qst"]
    layers = qst["lstm"]["layers"]
    vocab, word_embed = qst["word2vec"]["table"].shape
    if "darts" in params:
        encoder = dict(arch_type="darts", **_darts_dims(params))
    else:
        encoder = dict(arch_type="fixed",
                       vgg_fc_dim=params["vgg"]["fc7"]["w"].shape[1])
    return dataclasses.replace(
        ModelConfig(),
        img_embed_size=params["img_fc"]["w"].shape[1],
        word_embed_size=word_embed,
        lstm_hidden_size=layers[0]["w_hh"].shape[0],
        lstm_num_layers=len(layers),
        max_qst_len=meta["max_qst_len"],
        qst_vocab_size=vocab,
        ans_vocab_size=params["fc2"]["w"].shape[1],
        img_size=meta["img_size"],
        **encoder, **overrides)


def _prepare(tree, dtype: Optional[torch.dtype], node_kernel: bool = False):
    """The weights cast for the compute dtype once, at load, so that no
    call casts them again: linear weights rounded to it (kept fp32), conv
    weights (dense, depthwise and pointwise alike) cast to it, each LSTM
    layer's kernel weights under "cell" and, with `node_kernel`, each
    stride-1 mixed op's packed fp32 kernel weights under "node"."""
    if isinstance(tree, list):
        return [_prepare(t, dtype, node_kernel) for t in tree]
    if not isinstance(tree, dict):
        return tree
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


class ServingModel:
    """A loaded artifact on one device: params as tensors plus the model
    functions. `device` defaults to "cuda" and there is no fallback: on a
    host without a GPU, pass device="cpu" explicitly (the CPU runs the
    kernels' plain versions).

    Config overrides (`compute_dtype`, `use_pallas_lstm`,
    `pallas_seq_lstm`, `pallas_generate`, `pallas_mixed_op`) pick the
    numerics and the kernels. The weights are cast for the compute dtype
    and packed for the kernels once, here.

    A supernet's BatchNorm is batch-statistics (no artifact carries
    running statistics), so a row's answer depends on the other rows of
    the batch it is computed in."""

    def __init__(self, artifact: Dict[str, Any],
                 device: Union[str, torch.device] = "cuda", **overrides):
        meta = artifact["meta"]
        family = meta.get("family")
        if meta.get("int8"):
            raise NotImplementedError(
                "int8 artifacts are not ported yet (ROADMAP.md, queue 1 "
                "item 6); export without --int8")
        if family not in FUNCTIONS:
            raise NotImplementedError(
                f"{family!r} artifacts are not ported yet (the unified "
                "family comes with ROADMAP.md queue 1 item 5)")
        params = artifact["params"]["params"]
        if family == "ef":
            arch_type = ("derived" if "derived" in params else
                         "darts" if "darts" in params else "fixed")
            if meta.get("arch_type", arch_type) != arch_type:
                raise ValueError(
                    f"artifact meta says arch_type={meta['arch_type']!r} "
                    f"but its params hold a {arch_type!r} encoder")
            vqa_ef.check_arch_type(arch_type)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is "
                               "available; pass device='cpu' explicitly to "
                               "serve on the CPU")
        self.meta = meta
        self.family = family
        self.config = model_config(meta, params, **overrides)
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
        if family == "ef" and self.config.pallas_generate:
            self.params["qst"]["decode"] = cuda_generate.decode_weights(
                self.params["qst"], dtype)

    @property
    def functions(self):
        return list(FUNCTIONS[self.family])

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, dtype)

    @torch.inference_mode()
    def answer_logits(self, u8_images, qst_ids) -> torch.Tensor:
        """uint8 [B, S, S, 3] and int [B, T] -> fp32 logits [B, A]."""
        img = normalize_images(self._tensor(u8_images, torch.uint8))
        qst = self._tensor(qst_ids, torch.int64)
        if self.family == "w":
            return vqa_w.w_forward(self.params, self.config, img, qst)
        logits, _ = vqa_ef.ef_forward(self.params, self.arch, self.config,
                                      img, qst)
        return logits

    @torch.inference_mode()
    def generate(self, u8_images) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 [B, S, S, 3] -> (greedy question tokens int32 [B, T],
        answer ids [B])."""
        if self.family != "ef":
            raise ValueError("W-model artifacts have no generate function")
        img = normalize_images(self._tensor(u8_images, torch.uint8))
        qst, ans = vqa_ef.ef_generate(self.params, self.arch, self.config,
                                      img)
        return qst, torch.argmax(ans, dim=1)


def load_artifact(path: str, device: Union[str, torch.device] = "cuda",
                  trusted: bool = False, **overrides) -> ServingModel:
    return ServingModel(read_artifact(path, trusted=trusted), device,
                        **overrides)
