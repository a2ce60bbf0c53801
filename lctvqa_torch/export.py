"""Serving a JAX-exported artifact with the port (counterpart of
lctvqa/export.py's `ServingModel` and `load_artifact`).

An artifact is the ZIP that `lctvqa.export.save_artifact` writes. The
port reads its `params` and `meta` with `lctvqa.export.read_artifact`
(which needs no JAX) and ignores the StableHLO programs under
`exported/`: it runs its own model code, with its CUDA kernels, on the
params. Model dimensions come from the param shapes and `meta`; the
compute dtype and the kernel flags come from `ModelConfig`'s defaults
(bf16 operands, the LSTM cell kernel on) unless the caller overrides
them.

Served: W artifacts (`answer_logits`) and EF artifacts with the fixed
VGG19 encoder (`answer_logits`, `generate`). int8 artifacts, EF
artifacts with the darts or derived encoder and unified artifacts raise.
Writing `torch.export` artifacts is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from lctvqa.config import ModelConfig
from lctvqa.export import read_artifact
from lctvqa_torch import convert
from lctvqa_torch.data.pipeline import normalize_images
from lctvqa_torch.models import vqa_ef, vqa_w
from lctvqa_torch.ops import cuda_generate
from lctvqa_torch.ops import nn as N
from lctvqa_torch.ops.cuda_lstm import cell_weights

FUNCTIONS = {"w": ("answer_logits",), "ef": ("answer_logits", "generate")}


def model_config(meta: Dict[str, Any], params, **overrides) -> ModelConfig:
    """ModelConfig of an artifact: dims from the param shapes and meta,
    everything else from ModelConfig's defaults and `overrides`."""
    qst = params["qst"]
    layers = qst["lstm"]["layers"]
    vocab, word_embed = qst["word2vec"]["table"].shape
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
        arch_type="fixed",
        vgg_fc_dim=params["vgg"]["fc7"]["w"].shape[1],
        **overrides)


def _prepare(tree, dtype: Optional[torch.dtype]):
    """The weights cast for the compute dtype once, at load, so that no
    call casts them again: linear weights rounded to it (kept fp32), conv
    weights cast to it, and each LSTM layer's kernel weights under
    "cell"."""
    if isinstance(tree, list):
        return [_prepare(t, dtype) for t in tree]
    if not isinstance(tree, dict):
        return tree
    if "w_ih" in tree:
        return {**tree, "cell": cell_weights(tree, dtype)}
    if "w" in tree and tree["w"].dim() == 2:
        return N.prepare_linear(tree, dtype)
    if "w" in tree and dtype is not None:
        return {**tree, "w": tree["w"].to(dtype)}
    return {k: _prepare(v, dtype) for k, v in tree.items()}


class ServingModel:
    """A loaded artifact on one device: params as tensors plus the model
    functions. `device` defaults to "cuda" and there is no fallback: on a
    host without a GPU, pass device="cpu" explicitly (the CPU runs the
    kernels' plain versions).

    Config overrides (`compute_dtype`, `use_pallas_lstm`,
    `pallas_seq_lstm`, `pallas_generate`) pick the numerics and the
    kernels. The weights are cast for the compute dtype once, here."""

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
            arch_type = meta.get("arch_type", "fixed")
            if "darts" in params:
                arch_type = "darts"
            elif "derived" in params:
                arch_type = "derived"
            vqa_ef.check_fixed(arch_type)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is "
                               "available; pass device='cpu' explicitly to "
                               "serve on the CPU")
        self.meta = meta
        self.family = family
        self.config = model_config(meta, params, **overrides)
        dtype = N.torch_dtype(self.config.compute_dtype)
        self.params = _prepare(convert.from_jax(params, self.device), dtype)
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
        logits, _ = vqa_ef.ef_forward(self.params, None, self.config, img,
                                      qst)
        return logits

    @torch.inference_mode()
    def generate(self, u8_images) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 [B, S, S, 3] -> (greedy question tokens int32 [B, T],
        answer ids [B])."""
        if self.family != "ef":
            raise ValueError("W-model artifacts have no generate function")
        img = normalize_images(self._tensor(u8_images, torch.uint8))
        qst, ans = vqa_ef.ef_generate(self.params, None, self.config, img)
        return qst, torch.argmax(ans, dim=1)


def load_artifact(path: str, device: Union[str, torch.device] = "cuda",
                  trusted: bool = False, **overrides) -> ServingModel:
    return ServingModel(read_artifact(path, trusted=trusted), device,
                        **overrides)
