"""PC-DARTS search network (port of lctvqa/models/search.py) in NHWC.

Structure: stem conv3x3(3 -> 3C) + BN; `layers` cells with channel
doubling and reduction at layers//3 and 2*layers//3; each cell has
`steps` nodes whose every incoming edge is a partial-channel MixedOp (ops
applied to a 1/k channel slice, untouched channels concatenated back,
channel shuffle); edge outputs are weighted by per-edge betas (softmaxed
per node group) and op outputs by alphas (softmaxed per edge).
AdaptiveAvgPool(7) + flatten.

Params are nested dicts of fp32 tensors with the JAX package's tree and
names (conv weights OIHW); arch parameters (alphas_normal/reduce
[k_edges, 8], betas_normal/reduce [k_edges]) live in a separate dict.

With `cfg.pallas_mixed_op` each node's stride-1 edges go through one call
of the mixed-op node kernel (`ops/cuda_mixedop.py`), grouped as the JAX
package's `cell_apply_hwcn` groups them; the trunk stays NHWC, because
the CUDA kernel reads a channel slice through the tensor's strides.
`cfg.pack_conv_branches` runs the four depthwise-separable branches of a
folded mixture as one packed chain (`_mixed_fold_packed`; the stride-2
edges beside the node kernel stay unpacked, as in the JAX package's HWCN
trunk); `cfg.remat_cells` recomputes each cell in the backward
(`torch.utils.checkpoint`). The edge-batched cell (`fuse_mixed_ops`) is
models/search_fused.py.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from lctvqa_torch.config import ModelConfig
from lctvqa_torch.models.genotypes import NONE_IDX, PRIMITIVES, Genotype
from lctvqa_torch.ops import conv as C
from lctvqa_torch.ops import cuda_bn, cuda_mixedop

OUTPUT_SIZE = 7  # AdaptiveAvgPool2d(7)
f32 = torch.float32


# --------------------------------------------------------------------------
# Primitive ops. Each op: init(gen, ch, stride) -> params dict (possibly
# empty), apply(params, x, stride, dtype) -> y. BN layers inside ops are
# affine=False: parameter-free batch-stat normalization.
# --------------------------------------------------------------------------

def _sep_conv_init(gen, ch, k, affine=False):
    p = {
        "dw1": C.torch_conv_init(gen, k, k, ch, ch, groups=ch),
        "pw1": C.torch_conv_init(gen, 1, 1, ch, ch),
        "dw2": C.torch_conv_init(gen, k, k, ch, ch, groups=ch),
        "pw2": C.torch_conv_init(gen, 1, 1, ch, ch),
    }
    if affine:
        p["bn1"] = C.batchnorm_init(ch)
        p["bn2"] = C.batchnorm_init(ch)
    return p


def _sep_conv_apply(p, x, stride, k, dtype):
    pad = k // 2
    y = torch.relu(x)
    y = C.depthwise_conv2d(p["dw1"], y, stride=stride, padding=pad,
                           dtype=dtype)
    y = C.conv2d(p["pw1"], y, dtype=dtype)
    y = C.batchnorm(p.get("bn1", {}), y, out_dtype=dtype)
    y = torch.relu(y)
    y = C.depthwise_conv2d(p["dw2"], y, stride=1, padding=pad, dtype=dtype)
    y = C.conv2d(p["pw2"], y, dtype=dtype)
    return C.batchnorm(p.get("bn2", {}), y, out_dtype=dtype)


def _dil_conv_init(gen, ch, k, affine=False):
    p = {
        "dw": C.torch_conv_init(gen, k, k, ch, ch, groups=ch),
        "pw": C.torch_conv_init(gen, 1, 1, ch, ch),
    }
    if affine:
        p["bn"] = C.batchnorm_init(ch)
    return p


def _dil_conv_apply(p, x, stride, k, dtype):
    pad = k - 1  # dilation 2: pad 2 for k=3, pad 4 for k=5
    y = torch.relu(x)
    y = C.depthwise_conv2d(p["dw"], y, stride=stride, padding=pad,
                           dilation=2, dtype=dtype)
    y = C.conv2d(p["pw"], y, dtype=dtype)
    return C.batchnorm(p.get("bn", {}), y, out_dtype=dtype)


def _conv_7x1_1x7_init(gen, ch, affine=False):
    """ReLU -> 1x7 conv -> 7x1 conv -> BN (the AmoebaNet preset)."""
    p = {
        "conv_1x7": C.torch_conv_init(gen, 1, 7, ch, ch),
        "conv_7x1": C.torch_conv_init(gen, 7, 1, ch, ch),
    }
    if affine:
        p["bn"] = C.batchnorm_init(ch)
    return p


def _conv_7x1_1x7_apply(p, x, stride, dtype):
    y = torch.relu(x)
    y = C.conv2d(p["conv_1x7"], y, stride=(1, stride), padding=(0, 3),
                 dtype=dtype)
    y = C.conv2d(p["conv_7x1"], y, stride=(stride, 1), padding=(3, 0),
                 dtype=dtype)
    return C.batchnorm(p.get("bn", {}), y, out_dtype=dtype)


def factorized_reduce_init(gen, c_in, c_out, affine=False):
    if c_out % 2:
        raise ValueError(f"factorized reduce needs an even c_out, {c_out}")
    p = {
        "conv1": C.torch_conv_init(gen, 1, 1, c_in, c_out // 2),
        "conv2": C.torch_conv_init(gen, 1, 1, c_in, c_out // 2),
    }
    if affine:
        p["bn"] = C.batchnorm_init(c_out)
    return p


def _factorized_reduce_prebn(p, x, dtype, out_dtype=None):
    y = torch.relu(x)
    a = C.conv2d(p["conv1"], y, stride=2, dtype=dtype, out_dtype=out_dtype)
    b = C.conv2d(p["conv2"], y[:, 1:, 1:, :], stride=2, dtype=dtype,
                 out_dtype=out_dtype)
    return torch.cat([a, b], dim=-1)


def factorized_reduce_apply(p, x, dtype):
    """Two stride-2 1x1 convs on pixel-offset views, concat, BN."""
    return C.batchnorm(p.get("bn", {}), _factorized_reduce_prebn(p, x, dtype),
                       out_dtype=dtype)


def relu_conv_bn_init(gen, c_in, c_out, affine=False):
    p = {"conv": C.torch_conv_init(gen, 1, 1, c_in, c_out)}
    if affine:
        p["bn"] = C.batchnorm_init(c_out)
    return p


def relu_conv_bn_apply(p, x, dtype):
    y = C.conv2d(p["conv"], torch.relu(x), dtype=dtype)
    return C.batchnorm(p.get("bn", {}), y, out_dtype=dtype)


def op_init(gen, prim: str, ch: int, stride: int, affine: bool = False):
    if prim in ("sep_conv_3x3", "sep_conv_5x5", "sep_conv_7x7"):
        return _sep_conv_init(gen, ch, int(prim[-1]), affine)
    if prim in ("dil_conv_3x3", "dil_conv_5x5"):
        return _dil_conv_init(gen, ch, int(prim[-1]), affine)
    if prim == "conv_7x1_1x7":
        return _conv_7x1_1x7_init(gen, ch, affine)
    if prim == "skip_connect" and stride != 1:
        return factorized_reduce_init(gen, ch, ch, affine)
    return {}  # none / pools / identity have no parameters


def op_apply(p, prim: str, x, stride: int, dtype):
    acc = f32 if dtype is None else dtype
    if prim == "none":
        if stride == 1:
            return 0.0 * x.to(acc)
        return 0.0 * x[:, ::stride, ::stride, :].to(acc)
    if prim == "avg_pool_3x3":
        return C.batchnorm({}, C.avg_pool(x, 3, stride, 1,
                                          count_include_pad=False),
                           out_dtype=dtype)
    if prim == "max_pool_3x3":
        return C.batchnorm({}, C.max_pool(x, 3, stride, 1), out_dtype=dtype)
    if prim == "skip_connect":
        if stride == 1:
            return x
        return factorized_reduce_apply(p, x, dtype)
    if prim in ("sep_conv_3x3", "sep_conv_5x5", "sep_conv_7x7"):
        return _sep_conv_apply(p, x, stride, int(prim[-1]), dtype)
    if prim in ("dil_conv_3x3", "dil_conv_5x5"):
        return _dil_conv_apply(p, x, stride, int(prim[-1]), dtype)
    if prim == "conv_7x1_1x7":
        return _conv_7x1_1x7_apply(p, x, stride, dtype)
    raise ValueError(f"unknown primitive {prim}")


# --------------------------------------------------------------------------
# MixedOp: partial-channel weighted op mixture
# --------------------------------------------------------------------------

def channel_shuffle(x, groups: int):
    """NHWC channel shuffle: channel g * (C/groups) + i moves to
    i * groups + g."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups)
    return x.transpose(3, 4).reshape(n, h, w, c)


def mixed_op_init(gen, ch: int, stride: int, k: int):
    return {prim: op_init(gen, prim, ch // k, stride) for prim in PRIMITIVES}


def _op_prebn(p, prim: str, x, stride: int, dtype):
    """The primitive without its final affine-free BN (which _mixed_fold
    folds into the alpha mixture). Inner BNs (sep_conv's bn1) stay. All
    convs materialize at the compute dtype; BN statistics downstream
    accumulate in fp32 regardless."""
    od = dtype  # None -> fp32
    if prim == "avg_pool_3x3":
        return C.avg_pool(x, 3, stride, 1, count_include_pad=False)
    if prim == "max_pool_3x3":
        return C.max_pool(x, 3, stride, 1)
    if prim == "skip_connect":  # stride != 1 here (factorized reduce)
        return _factorized_reduce_prebn(p, x, dtype, od)
    if prim in ("sep_conv_3x3", "sep_conv_5x5", "sep_conv_7x7"):
        k = int(prim[-1])
        pad = k // 2
        y = torch.relu(x)
        y = C.depthwise_conv2d(p["dw1"], y, stride=stride, padding=pad,
                               dtype=dtype, out_dtype=od)
        y = C.conv2d(p["pw1"], y, dtype=dtype, out_dtype=od)
        y = C.batchnorm({}, y, out_dtype=dtype)   # inner bn1 (unfoldable)
        y = torch.relu(y)
        y = C.depthwise_conv2d(p["dw2"], y, stride=1, padding=pad,
                               dtype=dtype, out_dtype=od)
        return C.conv2d(p["pw2"], y, dtype=dtype, out_dtype=od)
    if prim in ("dil_conv_3x3", "dil_conv_5x5"):
        k = int(prim[-1])
        y = torch.relu(x)
        y = C.depthwise_conv2d(p["dw"], y, stride=stride, padding=k - 1,
                               dilation=2, dtype=dtype, out_dtype=od)
        return C.conv2d(p["pw"], y, dtype=dtype, out_dtype=od)
    raise ValueError(f"no pre-BN form for {prim}")


def _mixed_fold(p, x, weights, stride: int, dtype, eps: float = 1e-5):
    """alpha-mixture with every op's final affine-free BN folded in:

        sum_o a_o * BN(y_o) = sum_o (a_o * r_o) * y_o - sum_o a_o r_o mu_o
        with r_o = rsqrt(var_o + eps)

    The same math reordered; the 8 normalized intermediates are never
    materialized. 'none' contributes an exact 0 (skipped); stride-1
    skip_connect is the raw identity (no BN). The statistics are the
    global batch's under data parallelism (`cuda_bn.batch_moments`)."""
    out = None
    bias = None
    for i, prim in enumerate(PRIMITIVES):
        a = weights[i].to(f32)
        if prim == "none":
            continue
        if prim == "skip_connect" and stride == 1:
            term = a * x.to(f32)
        else:
            y32 = _op_prebn(p[prim], prim, x, stride, dtype).to(f32)
            mean, sq = cuda_bn.batch_moments(y32, (0, 1, 2))
            var = sq - mean * mean
            coef = a * torch.rsqrt(var + eps)           # [Cs]
            term = y32 * coef
            b = coef * mean
            bias = b if bias is None else bias + b
        out = term if out is None else out + term
    return out - bias


# The four depthwise-separable primitives share the chain shape
# relu -> depthwise -> pointwise [-> BN -> relu -> depthwise -> pointwise];
# _mixed_fold_packed runs them as one packed chain.
_PACKED_BRANCHES = ("sep_conv_3x3", "sep_conv_5x5",
                    "dil_conv_3x3", "dil_conv_5x5")
_SEP_MASK_PATTERN = (1.0, 1.0, 0.0, 0.0)   # which branches have stage 2


def _packed_dw1_kernel(p, cs: int):
    """[Cs*NB, 1, 9, 9] depthwise kernel (OIHW, Cs groups of NB outputs)
    holding each branch's first depthwise filter centered, dilated taps
    spread out. Output channel c*NB + b is branch b applied to input
    channel c: c-major, b-minor, the order of a grouped convolution's
    outputs."""
    nb = len(_PACKED_BRANCHES)
    ref = p["dil_conv_3x3"]["dw"]["w"]
    kern = ref.new_zeros((cs * nb, 1, 9, 9), dtype=f32)
    specs = (("sep_conv_3x3", "dw1", 3, 1), ("sep_conv_5x5", "dw1", 5, 1),
             ("dil_conv_3x3", "dw", 3, 2), ("dil_conv_5x5", "dw", 5, 2))
    ctr = 4
    for b, (prim, name, kk, dil) in enumerate(specs):
        half = (kk - 1) // 2 * dil
        sl = slice(ctr - half, ctr + half + 1, dil)
        kern[b::nb, :, sl, sl] = p[prim][name]["w"].to(f32)
    return kern


def _packed_dw2_kernel(p, cs: int):
    """[Cs*NB, 1, 5, 5] second-stage depthwise kernel: the sep branches'
    dw2 filters (centered), a delta (the identity) for the dil
    branches."""
    nb = len(_PACKED_BRANCHES)
    ref = p["sep_conv_3x3"]["dw2"]["w"]
    kern = ref.new_zeros((cs * nb, 1, 5, 5), dtype=f32)
    kern[0::nb, :, 1:4, 1:4] = ref.to(f32)
    kern[1::nb] = p["sep_conv_5x5"]["dw2"]["w"].to(f32)
    kern[2::nb, :, 2, 2] = 1.0
    kern[3::nb, :, 2, 2] = 1.0
    return kern


def _packed_pw_matrix(blocks, cs: int):
    """Block-diagonal-by-branch pointwise weight [Cs*NB, Cs*NB, 1, 1]
    (OIHW) in the interleaved (c-major, b-minor) channel order; a `None`
    block is the identity. One dense 1x1 convolution: no channel is
    de-interleaved."""
    nb = len(blocks)
    ref = next(w for w in blocks if w is not None)
    m = ref.new_zeros((cs * nb, cs * nb), dtype=f32)
    for b, w in enumerate(blocks):
        # OIHW [co, ci, 1, 1]: the block's rows are outputs
        m[b::nb, b::nb] = (torch.eye(cs, dtype=f32, device=ref.device)
                           if w is None else w[:, :, 0, 0].to(f32))
    return m[:, :, None, None]


def _mixed_fold_packed(p, x, weights, stride: int, dtype, eps: float = 1e-5):
    """_mixed_fold with the four depthwise-separable branches packed into
    one chain:

        relu(x)                                   (shared by the 4)
        -> one grouped 9x9 depthwise conv, stride s (filters centered,
                                                   dilation spread out)
        -> one block-diagonal 1x1 conv            (each branch's pw1)
        -> masked inner BN + ReLU                 (sep channels; the dil
                                                   channels pass)
        -> one 5x5 depthwise conv                 (sep dw2; a delta for dil)
        -> one block-diagonal 1x1 conv            (sep pw2; identity for dil)
        -> each channel's final BN and alpha folded, the branch axis summed

    Zero taps and zero blocks add exact zeros, so this is _mixed_fold's
    math with the same params; the final BN folds per packed channel
    because BN is per channel. Statistics as _mixed_fold's."""
    nb = len(_PACKED_BRANCHES)
    cs = x.shape[-1]
    out = None
    bias = None
    # pools, skip, none: as _mixed_fold
    for i, prim in enumerate(PRIMITIVES):
        a = weights[i].to(f32)
        if prim == "none" or prim in _PACKED_BRANCHES:
            continue
        if prim == "skip_connect" and stride == 1:
            term = a * x.to(f32)
        else:
            y32 = _op_prebn(p[prim], prim, x, stride, dtype).to(f32)
            mean, sq = cuda_bn.batch_moments(y32, (0, 1, 2))
            coef = a * torch.rsqrt(sq - mean * mean + eps)
            term = y32 * coef
            b = coef * mean
            bias = b if bias is None else bias + b
        out = term if out is None else out + term

    od = dtype
    z = C.conv2d({"w": _packed_dw1_kernel(p, cs)}, torch.relu(x),
                 stride=stride, padding=4, groups=cs, dtype=dtype,
                 out_dtype=od)
    z = C.conv2d({"w": _packed_pw_matrix(
        [p[pr]["pw1" if pr.startswith("sep") else "pw"]["w"]
         for pr in _PACKED_BRANCHES], cs)}, z, dtype=dtype, out_dtype=od)
    # masked inner BN + ReLU: sep channels normalized and rectified
    z32 = z.to(f32)
    mean1, sq1 = cuda_bn.batch_moments(z32, (0, 1, 2))
    sep = torch.tensor(_SEP_MASK_PATTERN, dtype=f32,
                       device=x.device).repeat(cs) > 0.0
    zn = (z32 - mean1) * torch.rsqrt(sq1 - mean1 * mean1 + eps)
    z2 = torch.where(sep, torch.relu(zn), z32)
    z2 = z2.to(od) if od is not None else z2
    w2 = C.conv2d({"w": _packed_dw2_kernel(p, cs)}, z2, stride=1, padding=2,
                  groups=cs * nb, dtype=dtype, out_dtype=od)
    y = C.conv2d({"w": _packed_pw_matrix(
        [p["sep_conv_3x3"]["pw2"]["w"], p["sep_conv_5x5"]["pw2"]["w"],
         None, None], cs)}, w2, dtype=dtype, out_dtype=od)
    # each branch's final BN and alpha folded; the branch axis summed
    y32 = y.to(f32)
    meanp, sqp = cuda_bn.batch_moments(y32, (0, 1, 2))
    alphas_b = torch.stack([weights[PRIMITIVES.index(pr)]
                            for pr in _PACKED_BRANCHES]).to(f32)
    coefp = alphas_b.repeat(cs) * torch.rsqrt(sqp - meanp * meanp + eps)
    term = (y32 * coefp).reshape(*y32.shape[:-1], cs, nb).sum(-1)
    biasp = (coefp * meanp).reshape(cs, nb).sum(-1)
    out = out + term
    bias = biasp if bias is None else bias + biasp
    return out - bias


def mixed_op_apply(p, x, weights, stride: int, k: int, dtype,
                   shuffle: bool = True, fold_bn: bool = False,
                   pack: bool = False):
    """ops on the first C/k channels, weighted-summed; the untouched rest
    concatenated (max-pooled 2x2 on a reduction edge); channel shuffle.

    shuffle=False defers the (shared) permutation to the caller: the cell
    sums beta-weighted edge outputs first and shuffles once per node,
    which is exact because channel_shuffle is linear. fold_bn=True routes
    through _mixed_fold (same math, final BNs folded into the mixture
    coefficients); pack=True as well packs the depthwise-separable
    branches (_mixed_fold_packed)."""
    cs = x.shape[-1] // k
    xtemp, xtemp2 = x[..., :cs], x[..., cs:]
    acc = f32 if dtype is None else dtype
    if fold_bn and pack:
        temp1 = _mixed_fold_packed(p, xtemp, weights, stride,
                                   dtype).to(acc)
    elif fold_bn:
        temp1 = _mixed_fold(p, xtemp, weights, stride, dtype).to(acc)
    else:
        outs = [op_apply(p[prim], prim, xtemp, stride, dtype)
                for prim in PRIMITIVES]
        # weights rounded to the op outputs' dtype, products summed in fp32
        temp1 = None
        for wgt, o in zip(weights.to(acc).to(f32), outs):
            term = wgt * o.to(f32)
            temp1 = term if temp1 is None else temp1 + term
        temp1 = temp1.to(acc)
    if stride == 1:
        rest = xtemp2.to(acc)
    else:
        rest = C.max_pool(xtemp2, 2, 2).to(acc)
    ans = torch.cat([temp1, rest], dim=-1)
    return channel_shuffle(ans, k) if shuffle else ans


# --------------------------------------------------------------------------
# Cell and Network
# --------------------------------------------------------------------------

def num_edges(steps: int) -> int:
    return sum(2 + i for i in range(steps))


def cell_init(gen, steps, c_pp, c_p, c, reduction, reduction_prev, k):
    p = {}
    if reduction_prev:
        p["pre0"] = factorized_reduce_init(gen, c_pp, c)
    else:
        p["pre0"] = relu_conv_bn_init(gen, c_pp, c)
    p["pre1"] = relu_conv_bn_init(gen, c_p, c)
    ops = []
    for i in range(steps):
        for j in range(2 + i):
            stride = 2 if reduction and j < 2 else 1
            ops.append(mixed_op_init(gen, c, stride, k))
    p["ops"] = ops
    return p


def cell_apply(p, s0, s1, alphas, betas, steps, multiplier, reduction,
               reduction_prev, k, dtype, fold_bn: bool = False,
               node_kernel: bool = False, pack: bool = False):
    """One cell. With `node_kernel` every node's stride-1 edges join one
    call of the mixed-op node kernel, which computes sum_j beta_j * mix_j
    of their partial-channel slices in one pass (weights beta_e *
    softmax(alpha_e)); the untouched channels are summed beta-weighted
    outside it; stride-2 edges take _mixed_fold (packed with `pack`). One
    shuffle per node either way."""
    if reduction_prev:
        s0 = factorized_reduce_apply(p["pre0"], s0, dtype)
    else:
        s0 = relu_conv_bn_apply(p["pre0"], s0, dtype)
    s1 = relu_conv_bn_apply(p["pre1"], s1, dtype)
    acc = f32 if dtype is None else dtype

    states = [s0, s1]
    offset = 0
    for i in range(steps):
        s = None
        group = []
        for j, h in enumerate(states):
            stride = 2 if reduction and j < 2 else 1
            if node_kernel and stride == 1:
                group.append(j)
                continue
            y = betas[offset + j] * mixed_op_apply(
                p["ops"][offset + j], h, alphas[offset + j], stride, k,
                dtype, shuffle=False, fold_bn=fold_bn, pack=pack)
            s = y if s is None else s + y
        if group:
            cs = states[group[0]].shape[-1] // k
            wts = torch.stack([betas[offset + j] * alphas[offset + j]
                               for j in group])
            mix = cuda_mixedop.mixed_node(
                [states[j].to(acc) for j in group],
                [p["ops"][offset + j] for j in group], wts, cs)
            rest = None
            for j in group:
                r = betas[offset + j] * states[j][..., cs:].to(f32)
                rest = r if rest is None else rest + r
            part = torch.cat([mix.to(acc), rest.to(acc)], dim=-1)
            s = part if s is None else s + part
        offset += len(states)
        states.append(channel_shuffle(s, k))
    return torch.cat(states[-multiplier:], dim=-1)


def cell_schedule(cfg: ModelConfig) -> List[dict]:
    """Static per-cell channel/reduction plan."""
    c_curr = cfg.darts_stem_multiplier * cfg.darts_init_ch
    c_pp, c_p = c_curr, c_curr
    c_curr = cfg.darts_init_ch
    sched = []
    reduction_prev = False
    for i in range(cfg.darts_layers):
        reduction = i in (cfg.darts_layers // 3, 2 * cfg.darts_layers // 3)
        if reduction:
            c_curr *= 2
        sched.append(dict(c_pp=c_pp, c_p=c_p, c=c_curr, reduction=reduction,
                          reduction_prev=reduction_prev))
        reduction_prev = reduction
        c_pp, c_p = c_p, cfg.darts_multiplier * c_curr
    return sched


def network_out_features(cfg: ModelConfig) -> int:
    c_prev = cfg.darts_multiplier * cell_schedule(cfg)[-1]["c"]
    return c_prev * OUTPUT_SIZE * OUTPUT_SIZE


def network_init(gen: torch.Generator, cfg: ModelConfig):
    c_stem = cfg.darts_stem_multiplier * cfg.darts_init_ch
    p = {
        "stem_conv": C.torch_conv_init(gen, 3, 3, 3, c_stem),
        "stem_bn": C.batchnorm_init(c_stem, affine=True),
        "cells": [],
    }
    for spec in cell_schedule(cfg):
        p["cells"].append(cell_init(
            gen, cfg.darts_steps, spec["c_pp"], spec["c_p"], spec["c"],
            spec["reduction"], spec["reduction_prev"], cfg.darts_partial_k))
    return p


def arch_init(gen: torch.Generator, cfg: ModelConfig):
    """1e-3 * randn."""
    k = num_edges(cfg.darts_steps)
    n = len(PRIMITIVES)
    return {
        "alphas_normal": 1e-3 * torch.randn(k, n, generator=gen),
        "alphas_reduce": 1e-3 * torch.randn(k, n, generator=gen),
        "betas_normal": 1e-3 * torch.randn(k, generator=gen),
        "betas_reduce": 1e-3 * torch.randn(k, generator=gen),
    }


def beta_softmax(betas, steps: int):
    """Per-node-group softmax of edge betas: groups of sizes 2, 3, ...,
    steps+1."""
    chunks = []
    start = 0
    for i in range(steps):
        n = 2 + i
        chunks.append(torch.softmax(betas[start:start + n], dim=0))
        start += n
    return torch.cat(chunks)


def remat_cells(cfg: ModelConfig) -> bool:
    """Whether each cell is recomputed in the backward (cfg.remat_cells):
    not under running statistics, whose contexts count the BatchNorm calls
    of one forward, and not where no gradient is taken, so that serving,
    validation and a traced program run the plain cell."""
    return (cfg.remat_cells and not cfg.bn_eval_stats
            and torch.is_grad_enabled())


def run_cell(fn, remat: bool, *args):
    """fn(*args), recomputed in the backward instead of kept where `remat`
    (`torch.utils.checkpoint`, non-reentrant, so it nests inside stage
    3's checkpoints and under create_graph). A cell draws no randomness:
    no RNG state is kept. Its recomputation takes the routes its forward
    took (`ops.conv.checkpoint_contexts`); under data parallelism it
    repeats the forward's all-reduces, in the same order on every rank."""
    if not remat:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=C.checkpoint_contexts)


def mixture_weights(arch, cfg: ModelConfig):
    """(softmaxed alphas, per-group softmaxed betas) of the normal and the
    reduction cells."""
    return (torch.softmax(arch["alphas_normal"].to(f32), dim=-1),
            beta_softmax(arch["betas_normal"].to(f32), cfg.darts_steps),
            torch.softmax(arch["alphas_reduce"].to(f32), dim=-1),
            beta_softmax(arch["betas_reduce"].to(f32), cfg.darts_steps))


def network_apply(p, arch, cfg: ModelConfig, x,
                  dtype: Optional[torch.dtype] = None):
    """x NHWC -> flattened pooled features [B, c_prev * 49]."""
    s = C.conv2d(p["stem_conv"], x, stride=1, padding=1, dtype=dtype)
    s0 = s1 = C.batchnorm(p["stem_bn"], s)
    w_norm, b_norm, w_red, b_red = mixture_weights(arch, cfg)

    # running-stats eval needs explicit per-op batchnorm calls, so it
    # forces the unfolded form
    fold_bn = cfg.fold_bn_mixture and not cfg.bn_eval_stats
    node_kernel = cfg.pallas_mixed_op and fold_bn
    # the kernel trunk's stride-2 edges take the unpacked fold, as the JAX
    # package's HWCN trunk's do
    pack = cfg.pack_conv_branches and fold_bn and not node_kernel
    remat = remat_cells(cfg)

    for cell_p, spec in zip(p["cells"], cell_schedule(cfg)):
        alphas, betas = ((w_red, b_red) if spec["reduction"]
                         else (w_norm, b_norm))

        def cell(cp, a, b, t0, t1, _spec=spec):
            return cell_apply(
                cp, t0, t1, a, b, cfg.darts_steps, cfg.darts_multiplier,
                _spec["reduction"], _spec["reduction_prev"],
                cfg.darts_partial_k, dtype, fold_bn=fold_bn,
                node_kernel=node_kernel, pack=pack)

        s0, s1 = s1, run_cell(cell, remat, cell_p, alphas, betas, s0, s1)
    out = C.adaptive_avg_pool(s1, OUTPUT_SIZE)
    # flatten in NCHW element order for reference weight compatibility
    return out.permute(0, 3, 1, 2).reshape(out.shape[0], -1)


def genotype(arch, steps: int = 4, multiplier: int = 4) -> Genotype:
    """Decode arch params to a discrete Genotype on the host: per node,
    keep the top-2 incoming edges ranked by beta * max non-'none' alpha;
    per kept edge, the best non-'none' op."""
    def _np(v):
        return np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v)

    def _softmax(v, axis=-1):
        e = np.exp(v - v.max(axis=axis, keepdims=True))
        return e / e.sum(axis=axis, keepdims=True)

    def _beta_cat(betas):
        chunks, start = [], 0
        for i in range(steps):
            n = 2 + i
            chunks.append(_softmax(betas[start:start + n]))
            start += n
        return np.concatenate(chunks)

    def _parse(weights, weights2):
        gene = []
        n, start = 2, 0
        for i in range(steps):
            end = start + n
            w = weights[start:end].copy() * weights2[start:end, None]
            edges = sorted(
                range(i + 2),
                key=lambda x: -max(w[x][kk] for kk in range(len(w[x]))
                                   if kk != NONE_IDX))[:2]
            for j in edges:
                k_best = None
                for kk in range(len(w[j])):
                    if kk == NONE_IDX:
                        continue
                    if k_best is None or w[j][kk] > w[j][k_best]:
                        k_best = kk
                gene.append((PRIMITIVES[k_best], j))
            start = end
            n += 1
        return gene

    gene_normal = _parse(_softmax(_np(arch["alphas_normal"])),
                         _beta_cat(_np(arch["betas_normal"])))
    gene_reduce = _parse(_softmax(_np(arch["alphas_reduce"])),
                         _beta_cat(_np(arch["betas_reduce"])))
    concat = list(range(2 + steps - multiplier, steps + 2))
    return Genotype(normal=gene_normal, normal_concat=concat,
                    reduce=gene_reduce, reduce_concat=concat)
