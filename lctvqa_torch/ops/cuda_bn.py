"""Affine-free batch-statistics BatchNorm, forward and backward: the two
kernels, their plain versions and the autograd function that joins them.

Counterpart of `lctvqa/ops/pallas_bn.py::batchnorm_pallas` and its
`custom_vjp`; the kernels are in `lctvqa_torch/csrc/bn.cu`. The forward
computes, over all but the last axis and per channel,
`(x - mean) * rsqrt(E[x^2] - mean^2 + eps)` in fp32 and casts the result
to `out_dtype`; it keeps `stat = (mean, rstd)` for the backward, which
computes `dx = rstd * (g - mean(g) - xhat * mean(g * xhat))` with fp32
sums and casts it to x's dtype. A wrapper takes the plain version only
for CPU tensors; for a CUDA tensor it launches the kernel or raises.
Unlike the TPU kernels there is no size limit above which a wrapper
gives way to the plain version: the kernels take every shape.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from lctvqa_torch.ops import _build as K

Tensor = torch.Tensor
f32 = torch.float32
EPS = 1e-5

BN_FWD = K.register(K.Kernel(
    "bn_fwd", "lctvqa_bn_fwd",
    [K.PTR] * 4 + [ctypes.c_longlong, K.INT, ctypes.c_float, K.INT, K.INT]))
BN_BWD = K.register(K.Kernel(
    "bn_bwd", "lctvqa_bn_bwd",
    [K.PTR] * 6 + [ctypes.c_longlong, K.INT, K.INT, K.INT]))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def batchnorm_stats_plain(x: Tensor, eps: float = EPS) -> Tensor:
    """x [..., C] -> stat [2, C] fp32: mean and 1/sqrt(var + eps)."""
    x32 = x.to(f32)
    axes = tuple(range(x.dim() - 1))
    mean = x32.mean(axes)
    var = (x32 * x32).mean(axes) - mean * mean
    return torch.stack([mean, torch.rsqrt(var + eps)])


def batchnorm_plain(x: Tensor, eps: float = EPS,
                    out_dtype: Optional[torch.dtype] = None) -> Tensor:
    """x [..., C] -> normalized, fp32 unless `out_dtype` is given."""
    mean, rstd = batchnorm_stats_plain(x, eps)
    y = (x.to(f32) - mean) * rstd
    return y if out_dtype is None else y.to(out_dtype)


def batchnorm_bwd_plain(x: Tensor, g: Tensor, stat: Tensor) -> Tensor:
    """The gradient of `batchnorm_plain` w.r.t. x given the output's
    gradient g and the forward's `stat`; in x's dtype."""
    axes = tuple(range(x.dim() - 1))
    mean, rstd = stat
    g32 = g.to(f32)
    xhat = (x.to(f32) - mean) * rstd
    dx = rstd * (g32 - g32.mean(axes) - xhat * (g32 * xhat).mean(axes))
    return dx.to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _aligned(x: Tensor) -> Tensor:
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernels move 16 bytes at a time
        x = x.clone()
    return x


def _scratch(c: int, device) -> Tensor:
    """Per-block partial sums [blocks, 2, C] of either kernel."""
    blocks = K.library().lctvqa_bn_max_blocks()
    return torch.empty(blocks, 2, c, dtype=f32, device=device)


def batchnorm_fwd_stat(x: Tensor, out_dtype: Optional[torch.dtype] = None,
                       eps: float = EPS) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (y, stat [2, C], the contiguous x the kernel read). CPU tensors
    take the plain version."""
    if x.device.type == "cpu":
        stat = batchnorm_stats_plain(x, eps)
        y = (x.to(f32) - stat[0]) * stat[1]
        return (y if out_dtype is None else y.to(out_dtype)), stat, x
    name = BN_FWD.name
    device = K.check_cuda_tensors(name, x=x)
    out_dtype = out_dtype or f32
    K.check(x.dim() >= 2 and x.numel() > 0, name,
            f"needs a non-empty [..., C] tensor, got {tuple(x.shape)}")
    c = x.shape[-1]
    x = _aligned(x)
    y = torch.empty(x.shape, dtype=out_dtype, device=device)
    stat = torch.empty(2, c, dtype=f32, device=device)
    BN_FWD.launch(device, x, y, _scratch(c, device), stat, x.numel() // c, c,
                  eps, K.dtype_code(name, x.dtype),
                  K.dtype_code(name, out_dtype))
    return y, stat, x


def batchnorm_bwd(x: Tensor, g: Tensor, stat: Tensor) -> Tensor:
    """dx of the affine-free batch-stat BN (replaces the backward of
    batchnorm_pallas). x [..., C] fp32 or bf16, g of x's shape fp32 or
    bf16, stat [2, C] fp32 from the forward -> dx in x's dtype."""
    if x.device.type == "cpu":
        return batchnorm_bwd_plain(x, g, stat)
    name = BN_BWD.name
    device = K.check_cuda_tensors(name, x=x, g=g, stat=stat)
    c = x.shape[-1]
    K.check(x.dim() >= 2 and x.numel() > 0 and g.shape == x.shape, name,
            f"needs x and g of one non-empty [..., C] shape, got "
            f"{tuple(x.shape)} and {tuple(g.shape)}")
    K.check(stat.shape == (2, c) and stat.dtype == f32
            and stat.is_contiguous(), name,
            f"stat must be contiguous fp32 [2, {c}]")
    x, g = _aligned(x), _aligned(g)
    dx = torch.empty_like(x)
    gstat = torch.empty(2, c, dtype=f32, device=device)
    BN_BWD.launch(device, x, g, stat, dx, _scratch(c, device), gstat,
                  x.numel() // c, c, K.dtype_code(name, x.dtype),
                  K.dtype_code(name, g.dtype))
    return dx


class BatchNormFn(torch.autograd.Function):
    """The forward kernel, then the backward kernel on the saved x and
    stat. First order only."""

    @staticmethod
    def forward(ctx, x: Tensor, out_dtype, eps: float) -> Tensor:
        y, stat, x_read = batchnorm_fwd_stat(x, out_dtype, eps)
        ctx.save_for_backward(x_read, stat)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g: Tensor):
        x, stat = ctx.saved_tensors
        return batchnorm_bwd(x, g, stat), None, None


def batchnorm_fwd(x: Tensor, out_dtype: Optional[torch.dtype] = None,
                  eps: float = EPS) -> Tensor:
    """Affine-free batch-stat BN of an NHWC tensor (replaces
    batchnorm_pallas), differentiable once. x [N, H, W, C] fp32 or bf16
    -> [N, H, W, C] in `out_dtype` (default fp32)."""
    if x.requires_grad and torch.is_grad_enabled():
        return BatchNormFn.apply(x, out_dtype, eps)
    return batchnorm_fwd_stat(x, out_dtype, eps)[0]
