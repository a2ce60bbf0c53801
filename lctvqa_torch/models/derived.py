"""Fixed network built from a Genotype, the "derived architecture"
retrained after a PC-DARTS search (port of lctvqa/models/derived.py), in
NHWC.

Cell structure of the standard DARTS derived network: per node, two
chosen ops (stride 2 for a reduction cell's edges from the two cell
inputs), affine BNs, node states summed, the `concat` nodes
concatenated. The ops are search.py's with `affine=True`; the pool ops'
BNs (the search skeleton's) stay affine-free, so with `USE_PALLAS_BN` on
they go through the BatchNorm kernel on the card (ops/conv.py), as the
JAX package's go through its Pallas BatchNorm on a TPU. Params are nested dicts of fp32
tensors with the JAX package's tree and names (conv weights OIHW).
`cfg.remat_cells` recomputes each cell in the backward, as the supernet's
(search.run_cell).

`cfg.derived_skeleton` picks the skeleton around the cells: "search" (the
default) is the search network's, a stride-1 stem conv + BN of 3C
channels and its channel plan; "imagenet" is DARTS's and PC-DARTS's
`NetworkImageNet` (model.py; the port's alone, the JAX package has no
such skeleton): `stem0` a stride-2 conv3x3 (3 -> C/2), BN, ReLU, a
stride-2 conv3x3 (C/2 -> C), BN; `stem1` ReLU, a stride-2 conv3x3
(C -> C), BN (224 px to 28); the first cell takes stem0's output through
a factorized reduce, as after a reduction; and the pools are the plain
`nn.MaxPool2d` / `nn.AvgPool2d` of DARTS's `OPS`, with no BN (the BN
after a pool belongs to the search network's MixedOp).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from lctvqa_torch.config import ModelConfig
from lctvqa_torch.models.genotypes import Genotype
from lctvqa_torch.models.search import (OUTPUT_SIZE, factorized_reduce_apply,
                                        factorized_reduce_init, op_apply,
                                        op_init, relu_conv_bn_apply,
                                        relu_conv_bn_init, remat_cells,
                                        run_cell)
from lctvqa_torch.ops import conv as C


def _gene(genotype: Genotype, reduction: bool):
    gene = genotype.reduce if reduction else genotype.normal
    concat = (genotype.reduce_concat if reduction
              else genotype.normal_concat)
    return list(gene), list(concat)


def _stride(reduction: bool, from_idx: int) -> int:
    return 2 if reduction and from_idx < 2 else 1


SKELETONS = ("search", "imagenet")
POOLS = ("max_pool_3x3", "avg_pool_3x3")


def _imagenet(cfg: ModelConfig) -> bool:
    if cfg.derived_skeleton not in SKELETONS:
        raise ValueError(f"unknown derived_skeleton {cfg.derived_skeleton!r}"
                         f": one of {SKELETONS}")
    return cfg.derived_skeleton == "imagenet"


def derived_cell_schedule(cfg: ModelConfig, genotype: Genotype) -> List[dict]:
    """Per-cell channel and reduction plan, search.cell_schedule's but for
    the concat width (the number of node states concatenated, the output
    channel multiplier), which comes from the genotype per cell type. So
    non-uniform presets (NASNet, AmoebaNet: 5 nodes, other concat widths
    for normal and reduce cells) build; for a uniform genotype it is
    search.cell_schedule. The ImageNet skeleton's first cell takes C
    channels from each stem, and stem0's at twice stem1's resolution."""
    imagenet = _imagenet(cfg)
    c_curr = (cfg.darts_init_ch if imagenet
              else cfg.darts_stem_multiplier * cfg.darts_init_ch)
    c_pp, c_p = c_curr, c_curr
    c_curr = cfg.darts_init_ch
    sched = []
    reduction_prev = imagenet
    for i in range(cfg.darts_layers):
        reduction = i in (cfg.darts_layers // 3, 2 * cfg.darts_layers // 3)
        if reduction:
            c_curr *= 2
        _, concat = _gene(genotype, reduction)
        sched.append(dict(c_pp=c_pp, c_p=c_p, c=c_curr, reduction=reduction,
                          reduction_prev=reduction_prev))
        reduction_prev = reduction
        c_pp, c_p = c_p, len(concat) * c_curr
    return sched


def derived_out_features(cfg: ModelConfig, genotype: Genotype) -> int:
    sched = derived_cell_schedule(cfg, genotype)
    _, concat = _gene(genotype, sched[-1]["reduction"])
    return len(concat) * sched[-1]["c"] * OUTPUT_SIZE * OUTPUT_SIZE


def derived_cell_init(gen: torch.Generator, genotype: Genotype, c_pp: int,
                      c_p: int, c: int, reduction: bool,
                      reduction_prev: bool):
    p = {}
    if reduction_prev:
        p["pre0"] = factorized_reduce_init(gen, c_pp, c, affine=True)
    else:
        p["pre0"] = relu_conv_bn_init(gen, c_pp, c, affine=True)
    p["pre1"] = relu_conv_bn_init(gen, c_p, c, affine=True)
    gene, _ = _gene(genotype, reduction)
    p["ops"] = [op_init(gen, name, c, _stride(reduction, from_idx),
                        affine=True) for name, from_idx in gene]
    return p


def _pool(name: str, x, stride: int, dtype):
    """A pool op with no BN after it (DARTS's OPS, the ImageNet skeleton's),
    cast to `dtype` as a BN's output would be."""
    if name == "max_pool_3x3":
        y = C.max_pool(x, 3, stride, 1)
    else:
        y = C.avg_pool(x, 3, stride, 1, count_include_pad=False)
    return y if dtype is None else y.to(dtype)


def derived_cell_apply(p, s0, s1, genotype: Genotype, reduction: bool,
                       reduction_prev: bool, dtype, pool_bn: bool = True):
    if reduction_prev:
        s0 = factorized_reduce_apply(p["pre0"], s0, dtype)
    else:
        s0 = relu_conv_bn_apply(p["pre0"], s0, dtype)
    s1 = relu_conv_bn_apply(p["pre1"], s1, dtype)
    gene, concat = _gene(genotype, reduction)
    states = [s0, s1]
    # the gene lists two ops per node: node i sums gene[2i] and gene[2i+1]
    for i in range(len(gene) // 2):
        parts = []
        for j in (2 * i, 2 * i + 1):
            name, from_idx = gene[j]
            stride = _stride(reduction, from_idx)
            if name in POOLS and not pool_bn:
                parts.append(_pool(name, states[from_idx], stride, dtype))
            else:
                parts.append(op_apply(p["ops"][j], name, states[from_idx],
                                      stride, dtype))
        states.append(parts[0] + parts[1])
    return torch.cat([states[i] for i in concat], dim=-1)


def derived_network_init(gen: torch.Generator, cfg: ModelConfig,
                         genotype: Genotype):
    """Stem and derived cells, on the search network's channel and
    reduction plan, so that a searched arch retrains at equal size; or
    the ImageNet skeleton's two stems and plan."""
    if _imagenet(cfg):
        c = cfg.darts_init_ch
        p = {
            "stem0": {"conv1": C.torch_conv_init(gen, 3, 3, 3, c // 2),
                      "bn1": C.batchnorm_init(c // 2),
                      "conv2": C.torch_conv_init(gen, 3, 3, c // 2, c),
                      "bn2": C.batchnorm_init(c)},
            "stem1": {"conv": C.torch_conv_init(gen, 3, 3, c, c),
                      "bn": C.batchnorm_init(c)},
            "cells": [],
        }
    else:
        c_stem = cfg.darts_stem_multiplier * cfg.darts_init_ch
        p = {
            "stem_conv": C.torch_conv_init(gen, 3, 3, 3, c_stem),
            "stem_bn": C.batchnorm_init(c_stem, affine=True),
            "cells": [],
        }
    for spec in derived_cell_schedule(cfg, genotype):
        p["cells"].append(derived_cell_init(
            gen, genotype, spec["c_pp"], spec["c_p"], spec["c"],
            spec["reduction"], spec["reduction_prev"]))
    return p


def _imagenet_stems(p, x, dtype):
    """NetworkImageNet's stem0 and stem1 -> (s0, s1), at 1/4 and 1/8 of
    the image's side."""
    st = p["stem0"]
    y = C.conv2d(st["conv1"], x, stride=2, padding=1, dtype=dtype)
    y = torch.relu(C.batchnorm(st["bn1"], y, out_dtype=dtype))
    y = C.conv2d(st["conv2"], y, stride=2, padding=1, dtype=dtype)
    s0 = C.batchnorm(st["bn2"], y, out_dtype=dtype)
    st = p["stem1"]
    y = C.conv2d(st["conv"], torch.relu(s0), stride=2, padding=1,
                 dtype=dtype)
    return s0, C.batchnorm(st["bn"], y, out_dtype=dtype)


def derived_network_apply(p, cfg: ModelConfig, genotype: Genotype,
                          x: torch.Tensor,
                          dtype: Optional[torch.dtype] = None):
    """x NHWC -> flattened pooled features [B, c_prev * 49]."""
    imagenet = _imagenet(cfg)
    if imagenet:
        s0, s1 = _imagenet_stems(p, x, dtype)
    else:
        s = C.conv2d(p["stem_conv"], x, stride=1, padding=1, dtype=dtype)
        s0 = s1 = C.batchnorm(p["stem_bn"], s)
    remat = remat_cells(cfg)
    for cell_p, spec in zip(p["cells"], derived_cell_schedule(cfg, genotype)):

        def cell(cp, t0, t1, _spec=spec):
            return derived_cell_apply(cp, t0, t1, genotype,
                                      _spec["reduction"],
                                      _spec["reduction_prev"], dtype,
                                      pool_bn=not imagenet)

        s0, s1 = s1, run_cell(cell, remat, cell_p, s0, s1)
    out = C.adaptive_avg_pool(s1, OUTPUT_SIZE)
    # flatten in NCHW element order for reference weight compatibility
    return out.permute(0, 3, 1, 2).reshape(out.shape[0], -1)
