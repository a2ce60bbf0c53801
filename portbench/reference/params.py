"""The shapes of the models' parameter trees, worked out from a
configuration's sizes, and seeded weights on them.

The trees are the layout the reference reads (and the program takes):
linear weights [in, out], conv weights OIHW, an LSTM layer's `w_ih` [E,
4H], `w_hh` [H, 4H] and two biases, BatchNorm's affine `scale` and
`bias`. `make` draws one tree from a seed on the device in one call of
`torch.randn` and scales each leaf by its kind.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.reference.model import PRIMITIVES, VGG19_CFG, cell_schedule

Shape = Tuple[int, ...]


def _linear(i: int, o: int) -> dict:
    return {"w": (i, o), "b": (o,)}


def _conv(o: int, i: int, kh: int, kw: int, bias: bool = False) -> dict:
    return {"w": (o, i, kh, kw), **({"b": (o,)} if bias else {})}


def _lstm(e: int, h: int) -> dict:
    return {"layers": [{"w_ih": (e, 4 * h), "w_hh": (h, 4 * h),
                        "b_ih": (4 * h,), "b_hh": (4 * h,)}]}


def _primitive(prim: str, ch: int, stride: int) -> dict:
    if prim.startswith("sep_conv"):
        k = int(prim[-1])
        return {"dw1": _conv(ch, 1, k, k), "pw1": _conv(ch, ch, 1, 1),
                "dw2": _conv(ch, 1, k, k), "pw2": _conv(ch, ch, 1, 1)}
    if prim.startswith("dil_conv"):
        k = int(prim[-1])
        return {"dw": _conv(ch, 1, k, k), "pw": _conv(ch, ch, 1, 1)}
    if prim == "skip_connect" and stride != 1:
        return {"conv1": _conv(ch // 2, ch, 1, 1),
                "conv2": _conv(ch // 2, ch, 1, 1)}
    return {}


def supernet_shapes(m: dict) -> dict:
    stem = m["darts_stem_multiplier"] * m["darts_init_ch"]
    k = m["darts_partial_k"]
    cells = []
    for spec in cell_schedule(m):
        c = spec["c"]
        cell = {"pre0": ({"conv1": _conv(c // 2, spec["c_pp"], 1, 1),
                          "conv2": _conv(c // 2, spec["c_pp"], 1, 1)}
                         if spec["reduction_prev"]
                         else {"conv": _conv(c, spec["c_pp"], 1, 1)}),
                "pre1": {"conv": _conv(c, spec["c_p"], 1, 1)}, "ops": []}
        for i in range(m["darts_steps"]):
            for j in range(2 + i):
                stride = 2 if spec["reduction"] and j < 2 else 1
                cell["ops"].append({p: _primitive(p, c // k, stride)
                                    for p in PRIMITIVES})
        cells.append(cell)
    return {"stem_conv": _conv(stem, 3, 3, 3),
            "stem_bn": {"scale": (stem,), "bias": (stem,)}, "cells": cells}


def supernet_features(m: dict) -> int:
    return m["darts_multiplier"] * cell_schedule(m)[-1]["c"] * 49


def arch_shapes(m: dict) -> dict:
    edges = sum(2 + i for i in range(m["darts_steps"]))
    n = len(PRIMITIVES)
    return {"alphas_normal": (edges, n), "alphas_reduce": (edges, n),
            "betas_normal": (edges,), "betas_reduce": (edges,)}


def ef_shapes(m: dict) -> dict:
    e, h, emb = m["word_embed_size"], m["lstm_hidden_size"], m["img_embed_size"]
    return {"darts": supernet_shapes(m),
            "img_fc": _linear(supernet_features(m), emb),
            "qst": {"word2vec": {"table": (m["qst_vocab_size"], e)},
                    "lstm": _lstm(e, h), "fc1": _linear(2 * h, emb),
                    "fc2": _linear(h, m["qst_vocab_size"])},
            "fc1": _linear(emb, m["ans_vocab_size"]),
            "fc2": _linear(m["ans_vocab_size"], m["ans_vocab_size"])}


def vgg_shapes(m: dict) -> dict:
    width, fc = m.get("vgg_width_mult", 1.0), m.get("vgg_fc_dim", 4096)
    convs, c_in = [], 3
    for v in VGG19_CFG:
        if v != "M":
            c_out = max(1, int(v * width))
            convs.append(_conv(c_out, c_in, 3, 3, bias=True))
            c_in = c_out
    return {"features": convs, "fc6": _linear(c_in * 49, fc),
            "fc7": _linear(fc, fc)}


def w_shapes(m: dict) -> dict:
    e, h, emb = m["word_embed_size"], m["lstm_hidden_size"], m["img_embed_size"]
    return {"vgg": vgg_shapes(m),
            "img_fc": _linear(m.get("vgg_fc_dim", 4096), emb),
            "qst": {"word2vec": {"table": (m["qst_vocab_size"], e)},
                    "lstm": _lstm(e, h), "fc": _linear(2 * h, emb)},
            "fc1": _linear(emb, m["ans_vocab_size"]),
            "fc2": _linear(m["ans_vocab_size"], m["ans_vocab_size"])}


def flat(tree, prefix: str = "") -> Dict[str, Shape]:
    """{"a/b/0/w": shape} of a shape tree (or a tensor tree's leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _std(path: str, shape: Shape) -> Tuple[float, float]:
    """(mean, std) of a leaf: He-normal for a conv or a ReLU trunk's
    linear weight, 1/sqrt(fan in) for the other linear weights, PyTorch's
    LSTM spread, N(0, 1) embeddings, small biases, BatchNorm's affine near
    (1, 0), 1e-3 architecture weights."""
    name = path.rsplit("/", 1)[-1]
    if path.startswith(("alphas", "betas")):
        return 0.0, 1e-3
    if name == "table":
        return 0.0, 1.0
    if name in ("w_ih", "w_hh", "b_ih", "b_hh"):
        h = shape[-1] // 4
        return 0.0, 1.0 / math.sqrt(3 * h)
    if name == "scale":
        return 1.0, 0.1
    if name in ("bias", "b"):
        return 0.0, 0.02
    if len(shape) == 4:
        return 0.0, math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
    fan_in = shape[0]
    relu = path.startswith("vgg/") or "/vgg/" in path
    return 0.0, math.sqrt((2.0 if relu else 1.0) / fan_in)


def make(shapes: dict, seed: int, device) -> dict:
    """A tree of float32 leaves drawn from `seed` on `device`: one normal
    draw for the whole tree, in the order of the sorted leaf paths, each
    leaf scaled by `_std`."""
    leaves = flat(shapes)
    order = sorted(leaves)
    total = sum(math.prod(leaves[p]) for p in order)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device)
    values, off = {}, 0
    for p in order:
        n = math.prod(leaves[p])
        mean, std = _std(p, leaves[p])
        values[p] = (z[off:off + n].view(leaves[p]) * std + mean).contiguous()
        off += n
    del z
    return _unflat(shapes, values, "")


def _unflat(shapes, values, prefix):
    if isinstance(shapes, dict):
        return {k: _unflat(v, values, f"{prefix}{k}/")
                for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_unflat(v, values, f"{prefix}{i}/")
                for i, v in enumerate(shapes)]
    return values[prefix.rstrip("/")]


def copy_into(program_tree, values: dict) -> None:
    """Write `values` (a tree) into the program's tree, leaf by leaf and
    by path. Raises where the two trees do not hold the same leaves of the
    same shapes."""
    want = flat(values)
    got = flat(program_tree)
    if set(want) != set(got):
        raise ValueError("the program's parameter tree differs from the "
                         f"configuration's: only the program has "
                         f"{sorted(set(got) - set(want))[:5]}, only the "
                         f"configuration {sorted(set(want) - set(got))[:5]}")
    with torch.no_grad():
        for path, t in got.items():
            if tuple(t.shape) != tuple(want[path].shape):
                raise ValueError(f"{path}: the program's shape "
                                 f"{tuple(t.shape)}, the configuration's "
                                 f"{tuple(want[path].shape)}")
            t.copy_(want[path])
