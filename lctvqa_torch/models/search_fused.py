"""Edge-batched ("fused") PC-DARTS cell execution (port of
lctvqa/models/search_fused.py), in NHWC.

All the edges of a node group (one node's incoming edges of one stride)
are concatenated along channels, and each of the 8 primitives runs once
per group on the E*Cs stacked channels:

- depthwise convolutions: the edges' filters concatenated, one grouped
  convolution over the stacked channels;
- pointwise 1x1 convolutions: one batched product over an explicit edge
  axis ('bhwec,ecd->bhwed'), operands rounded to the compute dtype and
  summed in fp32, as `ops.nn.linear` computes;
- pools, identity and zero: elementwise on the stacked tensor;
- the affine-free BatchNorms: per-channel statistics, so those of the
  stacked layout are each edge's (`ops.conv.batchnorm`, the BatchNorm
  kernel on the card where the default path takes it).

The alpha mixture and the beta edge sum contract once each. Same
parameter tree as models/search.py: `ModelConfig.fuse_mixed_ops` is a way
of running the supernet, not another model. As in the JAX package it
runs neither the node kernel (`pallas_mixed_op`), nor the packed chain
(`pack_conv_branches`), nor the recomputed cells (`remat_cells`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from lctvqa_torch.config import ModelConfig
from lctvqa_torch.models.genotypes import PRIMITIVES
from lctvqa_torch.models.search import (OUTPUT_SIZE, cell_schedule,
                                        factorized_reduce_apply,
                                        mixture_weights, relu_conv_bn_apply)
from lctvqa_torch.ops import conv as C
from lctvqa_torch.ops import cuda_bn

f32 = torch.float32


def _depthwise_stacked(x, w, stride=1, padding=0, dilation=1, dtype=None):
    """Depthwise conv on stacked channels; w [Ctot, 1, k, k] -> fp32."""
    return C.conv2d({"w": w}, x, stride=stride, padding=padding,
                    dilation=dilation, groups=x.shape[-1], dtype=dtype,
                    out_dtype=f32)


def _pointwise_edges(x, w_e, e: int, cs_in: int, dtype=None):
    """Per-edge 1x1 convs as one batched product. x [B, H, W, E*cs_in];
    w_e [E, cs_in, cs_out] -> fp32 [B, H, W, E*cs_out]."""
    bsz, hh, ww, _ = x.shape
    x5 = x.reshape(bsz, hh, ww, e, cs_in)
    if dtype is not None:
        x5, w_e = x5.to(dtype), w_e.to(dtype)
    y = torch.einsum("bhwec,ecd->bhwed", x5.to(f32), w_e.to(f32))
    return y.reshape(bsz, hh, ww, -1)


def _stack_dw(op_params, key):
    """[E*C, 1, k, k] from the edges' depthwise [C, 1, k, k]."""
    return torch.cat([p[key]["w"] for p in op_params], dim=0)


def _stack_pw(op_params, key):
    """[E, cs_in, cs_out] from the edges' OIHW [cs_out, cs_in, 1, 1]."""
    return torch.stack([p[key]["w"][:, :, 0, 0].t() for p in op_params])


def _sep_conv_batch(op_params: Sequence[dict], xs, stride, k, e, cs, dtype):
    pad = k // 2
    y = torch.relu(xs)
    y = _depthwise_stacked(y, _stack_dw(op_params, "dw1"), stride=stride,
                           padding=pad, dtype=dtype)
    y = _pointwise_edges(y, _stack_pw(op_params, "pw1"), e, cs, dtype)
    y = torch.relu(C.batchnorm({}, y))
    y = _depthwise_stacked(y, _stack_dw(op_params, "dw2"), stride=1,
                           padding=pad, dtype=dtype)
    y = _pointwise_edges(y, _stack_pw(op_params, "pw2"), e, cs, dtype)
    return C.batchnorm({}, y)


def _dil_conv_batch(op_params, xs, stride, k, e, cs, dtype):
    y = torch.relu(xs)
    y = _depthwise_stacked(y, _stack_dw(op_params, "dw"), stride=stride,
                           padding=k - 1, dilation=2, dtype=dtype)
    y = _pointwise_edges(y, _stack_pw(op_params, "pw"), e, cs, dtype)
    return C.batchnorm({}, y)


def _fact_reduce_batch_prebn(op_params, xs, e, cs, dtype):
    """E FactorizedReduces without their final affine-free BN: the 1x1
    stride-2 convs are strided slices and batched products; each edge's
    output channels are [conv1's || conv2's]."""
    y = torch.relu(xs)
    a = _pointwise_edges(y[:, ::2, ::2, :], _stack_pw(op_params, "conv1"),
                         e, cs, dtype)
    b = _pointwise_edges(y[:, 1::2, 1::2, :], _stack_pw(op_params, "conv2"),
                         e, cs, dtype)
    bsz, hh, ww, _ = a.shape
    a = a.reshape(bsz, hh, ww, e, cs // 2)
    b = b.reshape(bsz, hh, ww, e, cs // 2)
    return torch.cat([a, b], dim=-1).reshape(bsz, hh, ww, e * cs)


def _fact_reduce_batch(op_params, xs, e, cs, dtype):
    return C.batchnorm({}, _fact_reduce_batch_prebn(op_params, xs, e, cs,
                                                    dtype))


def _op_batch_prebn(prim, op_params, xs, stride, e, cs, dtype):
    """One primitive over all E edges stacked on channels, without its
    final affine-free BN (the caller folds it into the mixture weights).
    Inner BNs (sep_conv's bn1) stay."""
    if prim == "avg_pool_3x3":
        return C.avg_pool(xs, 3, stride, 1, count_include_pad=False)
    if prim == "max_pool_3x3":
        return C.max_pool(xs, 3, stride, 1)
    if prim == "skip_connect":  # stride != 1 here
        return _fact_reduce_batch_prebn(op_params, xs, e, cs, dtype)
    if prim in ("sep_conv_3x3", "sep_conv_5x5", "sep_conv_7x7"):
        kk = int(prim[-1])
        pad = kk // 2
        y = torch.relu(xs)
        y = _depthwise_stacked(y, _stack_dw(op_params, "dw1"),
                               stride=stride, padding=pad, dtype=dtype)
        y = _pointwise_edges(y, _stack_pw(op_params, "pw1"), e, cs, dtype)
        y = C.batchnorm({}, y, out_dtype=dtype)  # inner bn1 (unfoldable)
        y = _depthwise_stacked(torch.relu(y), _stack_dw(op_params, "dw2"),
                               stride=1, padding=pad, dtype=dtype)
        return _pointwise_edges(y, _stack_pw(op_params, "pw2"), e, cs,
                                dtype)
    if prim in ("dil_conv_3x3", "dil_conv_5x5"):
        kk = int(prim[-1])
        y = torch.relu(xs)
        y = _depthwise_stacked(y, _stack_dw(op_params, "dw"), stride=stride,
                               padding=kk - 1, dilation=2, dtype=dtype)
        return _pointwise_edges(y, _stack_pw(op_params, "pw"), e, cs, dtype)
    raise ValueError(f"no pre-BN batched form for {prim}")


def _op_batch(prim, op_params, xs, stride, e, cs, dtype):
    """One primitive over all E edges stacked on channels -> fp32."""
    if prim == "none":
        if stride == 1:
            return 0.0 * xs.to(f32)
        return 0.0 * xs[:, ::stride, ::stride, :].to(f32)
    if prim == "avg_pool_3x3":
        return C.batchnorm({}, C.avg_pool(xs, 3, stride, 1,
                                          count_include_pad=False))
    if prim == "max_pool_3x3":
        return C.batchnorm({}, C.max_pool(xs, 3, stride, 1))
    if prim == "skip_connect":
        if stride == 1:
            return xs.to(f32)
        return _fact_reduce_batch(op_params, xs, e, cs, dtype)
    if prim in ("sep_conv_3x3", "sep_conv_5x5"):
        return _sep_conv_batch(op_params, xs, stride, int(prim[-1]), e, cs,
                               dtype)
    if prim in ("dil_conv_3x3", "dil_conv_5x5"):
        return _dil_conv_batch(op_params, xs, stride, int(prim[-1]), e, cs,
                               dtype)
    raise ValueError(prim)


def _rest(states, cs: int, stride: int):
    """The untouched channels of each edge, [B, H', W', E, C-Cs], max-pooled
    2x2 on a reduction edge (fp32 there, the states' dtype else)."""
    e, c = len(states), states[0].shape[-1]
    rest = torch.stack([s[..., cs:] for s in states], dim=3)
    if stride != 1:
        r = rest.shape
        rest = C.max_pool(rest.reshape(r[0], r[1], r[2], -1), 2, 2)
        rest = rest.reshape(*rest.shape[:3], e, c - cs)
    return rest


def _shuffle(ans, k: int):
    """channel_shuffle over the last axis (groups=k)."""
    c = ans.shape[-1]
    ans = ans.reshape(*ans.shape[:-1], k, c // k)
    return ans.transpose(-1, -2).reshape(*ans.shape[:-2], c)


def _edge_group_fold(mixed_params: Sequence[dict], states, alphas, betas,
                     stride: int, k: int, dtype, eps: float = 1e-5):
    """Edge-batched mixture with BN folding and the beta edge sum folded
    in. Three exact reorderings at once:
      - each op's final affine-free BN folds into its mixture coefficient
        (search._mixed_fold): sum_o a_o BN(y_o) = sum_o (a_o r_o) y_o - bias;
      - the edge's beta folds into the same coefficient:
        sum_e b_e sum_o a_eo BN(y_eo) = sum_o sum_e (b_e a_eo r_eo) y_eo - ..;
      - channel_shuffle is one permutation shared by the edges, so it
        commutes with the beta sum and runs once per node group.
    None of the 8 normalized intermediates is written. Statistics are the
    global batch's under data parallelism (`cuda_bn.batch_moments`)."""
    e = len(states)
    c = states[0].shape[-1]
    cs = c // k
    xs = torch.cat([s[..., :cs] for s in states], dim=-1)
    w_eo = alphas.to(f32) * betas.to(f32)[:, None]          # [E, 8]
    acc = None
    bias = None
    for i, prim in enumerate(PRIMITIVES):
        if prim == "none":
            continue
        w_e = w_eo[:, i].repeat_interleave(cs)              # [E*Cs]
        if prim == "skip_connect" and stride == 1:
            term = xs.to(f32) * w_e                         # identity, no BN
        else:
            y32 = _op_batch_prebn(prim, [mp[prim] for mp in mixed_params],
                                  xs, stride, e, cs, dtype).to(f32)
            mean, sq = cuda_bn.batch_moments(y32, (0, 1, 2))
            coef = w_e * torch.rsqrt(sq - mean * mean + eps)
            term = y32 * coef
            b = coef * mean
            bias = b if bias is None else bias + b
        acc = term if acc is None else acc + term
    mix = acc - bias
    mix = mix.reshape(*mix.shape[:3], e, cs).sum(dim=3)      # beta edge sum
    # untouched channels: beta-weighted sum over the edges
    restw = torch.einsum("e,bhwec->bhwc", betas.to(f32),
                         _rest(states, cs, stride).to(f32))
    return _shuffle(torch.cat([mix, restw], dim=-1), k)


def _edge_group(mixed_params: Sequence[dict], states, alphas, betas,
                stride: int, k: int, dtype):
    """The unfolded group: every primitive with its own BN, the alpha
    mixture per edge, each edge shuffled, then the beta-weighted edge sum.
    mixed_params[e]: edge e's MixedOp params (keyed by primitive);
    states[e]: its source state [B, H, W, C]; alphas [E, 8] softmaxed;
    betas [E]. -> the group's part of the node state, fp32."""
    e = len(states)
    c = states[0].shape[-1]
    cs = c // k
    xs = torch.cat([s[..., :cs] for s in states], dim=-1)
    outs = torch.stack([
        _op_batch(prim, [mp[prim] for mp in mixed_params], xs, stride, e,
                  cs, dtype)
        for prim in PRIMITIVES])                  # [8, B, H', W', E*Cs]
    outs = outs.reshape(*outs.shape[:4], e, cs)
    temp1 = torch.einsum("eo,obhwec->bhwec", alphas.to(f32), outs)
    ans = torch.cat([temp1, _rest(states, cs, stride).to(f32)], dim=-1)
    return torch.einsum("e,bhwec->bhwc", betas.to(f32), _shuffle(ans, k))


def cell_apply_fused(p, s0, s1, alphas, betas, steps, multiplier, reduction,
                     reduction_prev, k, dtype, fold_bn: bool = False):
    """search.cell_apply's cell (same params and math) with the edges of
    each node grouped by stride; fold_bn routes through _edge_group_fold."""
    if reduction_prev:
        s0 = factorized_reduce_apply(p["pre0"], s0, dtype)
    else:
        s0 = relu_conv_bn_apply(p["pre0"], s0, dtype)
    s1 = relu_conv_bn_apply(p["pre1"], s1, dtype)

    group_fn = _edge_group_fold if fold_bn else _edge_group
    states = [s0, s1]
    offset = 0
    for i in range(steps):
        groups = {}
        for j in range(len(states)):
            stride = 2 if reduction and j < 2 else 1
            groups.setdefault(stride, []).append(j)
        node = None
        for stride, idxs in groups.items():
            edges = [offset + j for j in idxs]
            part = group_fn([p["ops"][n] for n in edges],
                            [states[j] for j in idxs], alphas[edges],
                            betas[edges], stride, k, dtype)
            node = part if node is None else node + part
        offset += len(states)
        states.append(node)
    return torch.cat(states[-multiplier:], dim=-1)


def network_apply_fused(p, arch, cfg: ModelConfig, x,
                        dtype: Optional[torch.dtype] = None):
    """search.network_apply with fused cells."""
    s = C.conv2d(p["stem_conv"], x, stride=1, padding=1, dtype=dtype)
    s0 = s1 = C.batchnorm(p["stem_bn"], s)
    w_norm, b_norm, w_red, b_red = mixture_weights(arch, cfg)
    fold_bn = cfg.fold_bn_mixture and not cfg.bn_eval_stats
    for cell_p, spec in zip(p["cells"], cell_schedule(cfg)):
        al, be = (w_red, b_red) if spec["reduction"] else (w_norm, b_norm)
        s0, s1 = s1, cell_apply_fused(
            cell_p, s0, s1, al, be, cfg.darts_steps, cfg.darts_multiplier,
            spec["reduction"], spec["reduction_prev"], cfg.darts_partial_k,
            dtype, fold_bn=fold_bn)
    out = C.adaptive_avg_pool(s1, OUTPUT_SIZE)
    # flatten in NCHW element order for reference weight compatibility
    return out.permute(0, 3, 1, 2).reshape(out.shape[0], -1)
