"""Post-training int8 quantization for the serving paths (port of
lctvqa/quant.py).

The scheme is the JAX package's, code for code:

- weights: symmetric int8 per output channel, scales computed once here
  (`ops/conv.py::quantize_weight`);
- activations: symmetric int8 per sample, a dynamic abs-max scale
  computed on the device per call (no calibration set);
- products: int8 x int8 with exact int32 sums (`ops/int8.py`: on the card
  cuBLASLt's GEMM on Hopper's int8 tensor cores), then dequantized and
  biased in fp32.

Quantization is by dispatch: `quantize_model` rewrites every eligible
conv or linear param dict {"w"[, "b"]} into {"w_q", "w_s"[, "b"]}, and
`ops/conv.py::conv2d` and `ops/nn.py::linear` route on the "w_q" key, so
the unchanged model forwards (vqa_w.w_forward, vqa_ef.ef_forward and
ef_generate over the VGG19, derived or fixed encoders, unified_generate)
run int8 when handed a quantized tree. Eligible, in the port's layouts:
a conv whose OIHW weight has more than one input channel per group
(HWIO's `w.shape[2] > 1` in the JAX package) and a linear {"w", "b"}.
Not quantized, as there:

- the question encoder and decoder ("qst"; the unified model's "qa"):
  recurrent error compounds across steps;
- depthwise convs ([C, 1, k, k]): bandwidth-bound, no tensor-core work
  to win back the quantization passes;
- BatchNorm: fp32 statistics as on the fp path.

It is an opt-in serving mode, not a parity path with the fp32 forward:
logits move by the quantization error. The PC-DARTS supernet is refused
(decode its genotype and retrain a derived network to serve int8).
"""

from __future__ import annotations

import torch

from lctvqa_torch.config import ModelConfig
from lctvqa_torch.models import vqa_ef, vqa_w
from lctvqa_torch.ops import conv as C
from lctvqa_torch.ops import nn as N

SUPERNET_REFUSED = ("quantize the derived/fixed serving model, not the "
                    "search supernet")


def _quantize_tree(t):
    """Rewrite the eligible conv and linear param dicts of a tree (the
    port's layout) into their int8 form; everything else as it is."""
    if isinstance(t, dict):
        w = t.get("w")
        if isinstance(w, torch.Tensor):
            if w.dim() == 4 and w.shape[1] > 1:
                return C.quantize_conv_params(t)
            if w.dim() == 2 and "b" in t:
                return N.quantize_linear_params(t)
            return t  # a depthwise conv stays on the fp path
        return {k: _quantize_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_quantize_tree(v) for v in t]
    if isinstance(t, tuple):
        return tuple(_quantize_tree(v) for v in t)
    return t


def quantize_model(params) -> dict:
    """A model's fp32 params -> its int8 serving params (weights
    quantized once). The W model, the EF model and the unified model
    with the fixed VGG19 or a derived encoder; the recurrent subtrees
    ("qst", "qa") are kept as they are. The supernet ("darts") raises."""
    if "darts" in params:
        raise ValueError(SUPERNET_REFUSED)
    return {k: (v if k in ("qst", "qa") else _quantize_tree(v))
            for k, v in params.items()}


@torch.no_grad()
def w_forward_int8(qparams, cfg: ModelConfig, img, qst) -> torch.Tensor:
    """The deterministic W forward over a quantized tree -> logits."""
    return vqa_w.w_forward(qparams, cfg, img, qst, deterministic=True)


@torch.no_grad()
def ef_forward_int8(qparams, arch, cfg: ModelConfig, img, qst):
    """The deterministic EF forward over a quantized tree -> (answer
    logits, question logits)."""
    return vqa_ef.ef_forward(qparams, arch, cfg, img, qst,
                             deterministic=True)


@torch.no_grad()
def ef_generate_int8(qparams, arch, cfg: ModelConfig, img):
    """Greedy question generation and its answer over the int8 trunk; the
    LSTM decode stays on the fp path."""
    return vqa_ef.ef_generate(qparams, arch, cfg, img, deterministic=True,
                              sample_deterministic=True)
