"""Fixed network built from a Genotype, the "derived architecture"
retrained after a PC-DARTS search (port of lctvqa/models/derived.py), in
NHWC.

Cell structure of the standard DARTS derived network: per node, two
chosen ops (stride 2 for a reduction cell's edges from the two cell
inputs), affine BNs, node states summed, the `concat` nodes
concatenated. The ops are search.py's with `affine=True`; the pool ops'
BNs stay affine-free, so with `USE_PALLAS_BN` on they go through the
BatchNorm kernel on the card (ops/conv.py), as the JAX package's go
through its Pallas BatchNorm on a TPU. Params are nested dicts of fp32
tensors with the JAX package's tree and names (conv weights OIHW).
`cfg.remat_cells` recomputes each cell in the backward, as the supernet's
(search.run_cell).
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


def derived_cell_schedule(cfg: ModelConfig, genotype: Genotype) -> List[dict]:
    """Per-cell channel and reduction plan, search.cell_schedule's but for
    the concat width (the number of node states concatenated, the output
    channel multiplier), which comes from the genotype per cell type. So
    non-uniform presets (NASNet, AmoebaNet: 5 nodes, other concat widths
    for normal and reduce cells) build; for a uniform genotype it is
    search.cell_schedule."""
    c_curr = cfg.darts_stem_multiplier * cfg.darts_init_ch
    c_pp, c_p = c_curr, c_curr
    c_curr = cfg.darts_init_ch
    sched = []
    reduction_prev = False
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


def derived_cell_apply(p, s0, s1, genotype: Genotype, reduction: bool,
                       reduction_prev: bool, dtype):
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
            parts.append(op_apply(p["ops"][j], name, states[from_idx],
                                  _stride(reduction, from_idx), dtype))
        states.append(parts[0] + parts[1])
    return torch.cat([states[i] for i in concat], dim=-1)


def derived_network_init(gen: torch.Generator, cfg: ModelConfig,
                         genotype: Genotype):
    """Stem and derived cells, on the search network's channel and
    reduction plan, so that a searched arch retrains at equal size."""
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


def derived_network_apply(p, cfg: ModelConfig, genotype: Genotype,
                          x: torch.Tensor,
                          dtype: Optional[torch.dtype] = None):
    """x NHWC -> flattened pooled features [B, c_prev * 49]."""
    s = C.conv2d(p["stem_conv"], x, stride=1, padding=1, dtype=dtype)
    s0 = s1 = C.batchnorm(p["stem_bn"], s)
    remat = remat_cells(cfg)
    for cell_p, spec in zip(p["cells"], derived_cell_schedule(cfg, genotype)):

        def cell(cp, t0, t1, _spec=spec):
            return derived_cell_apply(cp, t0, t1, genotype,
                                      _spec["reduction"],
                                      _spec["reduction_prev"], dtype)

        s0, s1 = s1, run_cell(cell, remat, cell_p, s0, s1)
    out = C.adaptive_avg_pool(s1, OUTPUT_SIZE)
    # flatten in NCHW element order for reference weight compatibility
    return out.permute(0, 3, 1, 2).reshape(out.shape[0], -1)
