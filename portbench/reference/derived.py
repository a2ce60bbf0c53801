"""Plain PyTorch reference of PC-DARTS's ImageNet network as the LCT EF's
image encoder, and the EF's training steps around it.

Written from the published network, independent of the program: DARTS's
and PC-DARTS's `model.py::NetworkImageNet` (github.com/yuhuixu1993/
PC-DARTS; Xu et al., ICLR 2020, arXiv:1907.05737) with the cell searched
on ImageNet, `genotypes.py::PC_DARTS_image`, at `train_imagenet.py`'s 14
cells and 48 initial channels:
- stem0: conv3x3 stride 2 (3 -> C/2), BN, ReLU, conv3x3 stride 2
  (C/2 -> C), BN; stem1: ReLU, conv3x3 stride 2 (C -> C), BN;
- cells on (stem0, stem1), the first with `reduction_prev`: its s0
  preprocess a FactorizedReduce (ReLU, two stride-2 1x1 convs, the second
  on the input shifted by one pixel, concatenated, BN); otherwise
  ReLU-conv1x1-BN; cells layers//3 and 2*layers//3 reduce and double C;
  each node sums two ops of the genotype (stride 2 on a reduction cell's
  edges from its two inputs), the cell concatenates its `concat` nodes;
- the ops are `operations.py::OPS[name](C, stride, affine=True)`:
  sep_conv (ReLU, depthwise, pointwise, BN, twice), dil_conv (ReLU,
  dilation-2 depthwise, pointwise, BN), max_pool_3x3 (a pool and no BN),
  skip_connect (the identity, a FactorizedReduce at stride 2).

Departures from the published network:
- no auxiliary head: it adds an ImageNet classification loss, and VQA has
  no class labels;
- drop path 0, the default of the DARTS and PC-DARTS ImageNet scripts;
- the 1,000-way classifier is the LCT EF's image head in its place:
  adaptive average pool to 7x7 (the identity on the 7x7 map at 224 px),
  flatten channel-major, `img_fc`, L2-normalize;
- every BatchNorm normalizes by the batch's statistics (as in the
  program and in `reference/model.py`).

It computes in float32 in NCHW (TF32 off under `model.exact_matmuls`),
or with a `model.Numerics` rounding the operands of every product (the
control). It reads the program's parameter tree by name (conv weights
OIHW, BatchNorm `scale` and `bias`) and imports nothing of the program.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from portbench.reference import model as R
from portbench.reference import params as P

# genotypes.py::PC_DARTS_image: (op, input state) two a node
GENOTYPES = {
    "PC_DARTS_image": {
        "normal": [("skip_connect", 1), ("sep_conv_3x3", 0),
                   ("sep_conv_3x3", 0), ("skip_connect", 1),
                   ("sep_conv_3x3", 1), ("sep_conv_3x3", 3),
                   ("sep_conv_3x3", 1), ("dil_conv_5x5", 4)],
        "normal_concat": [2, 3, 4, 5],
        "reduce": [("sep_conv_3x3", 0), ("skip_connect", 1),
                   ("dil_conv_5x5", 2), ("max_pool_3x3", 1),
                   ("sep_conv_3x3", 2), ("sep_conv_3x3", 1),
                   ("sep_conv_5x5", 0), ("sep_conv_3x3", 3)],
        "reduce_concat": [2, 3, 4, 5],
    },
}


def genotype(m: dict) -> dict:
    return GENOTYPES[m["genotype"]]


def _gene(g: dict, reduction: bool):
    key = "reduce" if reduction else "normal"
    return g[key], g[key + "_concat"]


def cell_schedule(m: dict) -> List[dict]:
    """NetworkImageNet's cells: input widths, width, reduction flags."""
    g, layers = genotype(m), m["darts_layers"]
    c_pp = c_p = c = m["darts_init_ch"]
    out, red_prev = [], True
    for i in range(layers):
        red = i in (layers // 3, 2 * layers // 3)
        if red:
            c *= 2
        out.append(dict(c_pp=c_pp, c_p=c_p, c=c, reduction=red,
                        reduction_prev=red_prev))
        red_prev = red
        c_pp, c_p = c_p, len(_gene(g, red)[1]) * c
    return out


def out_features(m: dict) -> int:
    spec = cell_schedule(m)[-1]
    return len(_gene(genotype(m), spec["reduction"])[1]) * spec["c"] * 49


# --------------------------------------------------------------------------
# parameter shapes, in the program's tree
# --------------------------------------------------------------------------

def _bn(c: int) -> dict:
    return {"scale": (c,), "bias": (c,)}


def _op_shapes(name: str, c: int, stride: int) -> dict:
    if name.startswith("sep_conv"):
        k = int(name[-1])
        return {"dw1": P._conv(c, 1, k, k), "pw1": P._conv(c, c, 1, 1),
                "bn1": _bn(c), "dw2": P._conv(c, 1, k, k),
                "pw2": P._conv(c, c, 1, 1), "bn2": _bn(c)}
    if name.startswith("dil_conv"):
        k = int(name[-1])
        return {"dw": P._conv(c, 1, k, k), "pw": P._conv(c, c, 1, 1),
                "bn": _bn(c)}
    if name == "skip_connect" and stride == 2:
        return _fr_shapes(c, c)
    return {}


def _fr_shapes(c_in: int, c_out: int) -> dict:
    return {"conv1": P._conv(c_out // 2, c_in, 1, 1),
            "conv2": P._conv(c_out // 2, c_in, 1, 1), "bn": _bn(c_out)}


def network_shapes(m: dict) -> dict:
    g, c = genotype(m), m["darts_init_ch"]
    cells = []
    for spec in cell_schedule(m):
        cc = spec["c"]
        gene, _ = _gene(g, spec["reduction"])
        cells.append({
            "pre0": (_fr_shapes(spec["c_pp"], cc) if spec["reduction_prev"]
                     else {"conv": P._conv(cc, spec["c_pp"], 1, 1),
                           "bn": _bn(cc)}),
            "pre1": {"conv": P._conv(cc, spec["c_p"], 1, 1), "bn": _bn(cc)},
            "ops": [_op_shapes(name, cc, 2 if spec["reduction"] and j < 2
                               else 1) for name, j in gene]})
    return {"stem0": {"conv1": P._conv(c // 2, 3, 3, 3), "bn1": _bn(c // 2),
                      "conv2": P._conv(c, c // 2, 3, 3), "bn2": _bn(c)},
            "stem1": {"conv": P._conv(c, c, 3, 3), "bn": _bn(c)},
            "cells": cells}


def ef_shapes(m: dict) -> dict:
    """The EF's tree with this network as its image encoder."""
    e, h, emb = m["word_embed_size"], m["lstm_hidden_size"], m["img_embed_size"]
    return {"derived": network_shapes(m),
            "img_fc": P._linear(out_features(m), emb),
            "qst": {"word2vec": {"table": (m["qst_vocab_size"], e)},
                    "lstm": P._lstm(e, h), "fc1": P._linear(2 * h, emb),
                    "fc2": P._linear(h, m["qst_vocab_size"])},
            "fc1": P._linear(emb, m["ans_vocab_size"]),
            "fc2": P._linear(m["ans_vocab_size"], m["ans_vocab_size"])}


# --------------------------------------------------------------------------
# the network (NCHW)
# --------------------------------------------------------------------------

def _affine_bn(p: dict, x):
    return R.bn(x, p["scale"], p["bias"])


def relu_conv_bn(q, p, x):
    return _affine_bn(p["bn"], R.conv(q, p["conv"], torch.relu(x)))


def factorized_reduce(q, p, x):
    y = torch.relu(x)
    return _affine_bn(p["bn"], torch.cat(
        [R.conv(q, p["conv1"], y, stride=2),
         R.conv(q, p["conv2"], y[:, :, 1:, 1:], stride=2)], 1))


def op(q, name: str, p: dict, x, stride: int):
    if name == "max_pool_3x3":
        return F.max_pool2d(x, 3, stride, 1)
    if name == "avg_pool_3x3":
        return F.avg_pool2d(x, 3, stride, 1, count_include_pad=False)
    if name == "skip_connect":
        return x if stride == 1 else factorized_reduce(q, p, x)
    k, ch = int(name[-1]), x.shape[1]
    if name.startswith("sep_conv"):
        y = R.conv(q, p["dw1"], torch.relu(x), stride, k // 2, groups=ch)
        y = torch.relu(_affine_bn(p["bn1"], R.conv(q, p["pw1"], y)))
        y = R.conv(q, p["dw2"], y, 1, k // 2, groups=ch)
        return _affine_bn(p["bn2"], R.conv(q, p["pw2"], y))
    if name.startswith("dil_conv"):
        y = R.conv(q, p["dw"], torch.relu(x), stride, k - 1, dilation=2,
                   groups=ch)
        return _affine_bn(p["bn"], R.conv(q, p["pw"], y))
    raise ValueError(f"no op {name!r} in this network")


def cell(q, cp: dict, s0, s1, g: dict, spec: dict):
    t0 = (factorized_reduce(q, cp["pre0"], s0) if spec["reduction_prev"]
          else relu_conv_bn(q, cp["pre0"], s0))
    states = [t0, relu_conv_bn(q, cp["pre1"], s1)]
    gene, concat = _gene(g, spec["reduction"])
    for i in range(len(gene) // 2):
        node = None
        for j in (2 * i, 2 * i + 1):
            name, src = gene[j]
            stride = 2 if spec["reduction"] and src < 2 else 1
            y = op(q, name, cp["ops"][j], states[src], stride)
            node = y if node is None else node + y
        states.append(node)
    return torch.cat([states[i] for i in concat], 1)


def stem0(q, p: dict, x):
    """The image NCHW -> stem0's output, at 1/4 of its side."""
    st = p["stem0"]
    y = torch.relu(_affine_bn(st["bn1"], R.conv(q, st["conv1"], x, stride=2,
                                                 padding=1)))
    return _affine_bn(st["bn2"], R.conv(q, st["conv2"], y, stride=2,
                                        padding=1))


def stem1(q, p: dict, s0):
    """stem0's output -> stem1's, at 1/8 of the image's side."""
    st = p["stem1"]
    return _affine_bn(st["bn"], R.conv(q, st["conv"], torch.relu(s0),
                                       stride=2, padding=1))


def cell_at(q, p: dict, m: dict, k: int, s0, s1):
    """Cell k on its two inputs (the outputs of the two states before
    it: stem0's and stem1's for cell 0)."""
    return cell(q, p["cells"][k], s0, s1, genotype(m), cell_schedule(m)[k])


def head(s):
    """The last cell's output -> the pooled features, flattened
    channel-major."""
    return F.adaptive_avg_pool2d(s, R.OUTPUT_SIZE).flatten(1)


def network(q, p: dict, m: dict, x, states: list = None):
    """x NCHW -> [B, C_prev * 49] pooled features; stem0's, stem1's and
    each cell's output appended to `states`, where given."""
    s0 = stem0(q, p, x)
    s1 = stem1(q, p, s0)
    if states is not None:
        states += [s0, s1]
    for k in range(m["darts_layers"]):
        s0, s1 = s1, cell_at(q, p, m, k, s0, s1)
        if states is not None:
            states.append(s1)
    return head(s1)


# --------------------------------------------------------------------------
# the EF around it, and its steps (W's and the heads are model.py's)
# --------------------------------------------------------------------------

def ef_image(q, p, m, img):
    return R.l2_normalize(R.linear(q, p["img_fc"],
                                   network(q, p["derived"], m, img)))


def ef_forward(q, p, m, img, qst, gen):
    """-> (answer logits, question logits)."""
    img_feat = ef_image(q, p, m, img)
    qst_feat, logits = R.ef_encode(q, p, img_feat, qst)
    return (R.answer_head(q, p, img_feat, qst_feat, m["dropout_rate"], gen),
            logits)


def stage1(q, ef, m, opt: R.Adam, img, qst, labels, gen):
    """The EF's step, as `model.stage1` -> (new params, loss, the clipped
    gradient)."""
    p = R.with_grad(ef)
    ans, logits = ef_forward(q, p, m, img, qst, gen)
    v = logits.shape[-1]
    loss = (R.cross_entropy(ans, labels)
            + R.cross_entropy(logits[:, :-1].reshape(-1, v),
                              qst[:, 1:].reshape(-1)))
    new, g = opt.update(ef, R.grads_of(loss, p))
    return new, float(loss.detach()), g
