"""Affine-free batch-statistics BatchNorm, forward: the kernel and its
plain version.

Counterpart of `lctvqa/ops/pallas_bn.py::batchnorm_pallas` (forward; the
backward comes with training); the kernel is in
`lctvqa_torch/csrc/bn.cu`. Both versions compute, over all but the last
axis and per channel, `(x - mean) * rsqrt(E[x^2] - mean^2 + eps)` in
fp32 and cast the result to `out_dtype`. The wrapper takes the plain
version only for CPU tensors; for a CUDA tensor it launches the kernel
or raises. Unlike the TPU kernel there is no size limit above which
the wrapper gives way to the plain version: the kernel takes every
shape.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from lctvqa_torch.ops import _build as K

Tensor = torch.Tensor
f32 = torch.float32
EPS = 1e-5

BN_FWD = K.register(K.Kernel(
    "bn_fwd", "lctvqa_bn_fwd",
    [K.PTR] * 4 + [ctypes.c_longlong, K.INT, ctypes.c_float, K.INT, K.INT]))


def batchnorm_plain(x: Tensor, eps: float = EPS,
                    out_dtype: Optional[torch.dtype] = None) -> Tensor:
    """x [..., C] -> normalized, fp32 unless `out_dtype` is given."""
    x32 = x.to(f32)
    axes = tuple(range(x.dim() - 1))
    mean = x32.mean(axes)
    var = (x32 * x32).mean(axes) - mean * mean
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return y if out_dtype is None else y.to(out_dtype)


def batchnorm_fwd(x: Tensor, out_dtype: Optional[torch.dtype] = None,
                  eps: float = EPS) -> Tensor:
    """Affine-free batch-stat BN of an NHWC tensor (replaces
    batchnorm_pallas). x [N, H, W, C] fp32 or bf16 -> [N, H, W, C] in
    `out_dtype` (default fp32)."""
    if x.device.type == "cpu":
        return batchnorm_plain(x, eps, out_dtype)
    name = BN_FWD.name
    device = K.check_cuda_tensors(name, x=x)
    out_dtype = out_dtype or f32
    K.check(x.dim() >= 2 and x.numel() > 0, name,
            f"needs a non-empty [..., C] tensor, got {tuple(x.shape)}")
    c = x.shape[-1]
    m = x.numel() // c
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel moves 16 bytes at a time
        x = x.clone()
    y = torch.empty(x.shape, dtype=out_dtype, device=device)
    # one scratch tensor: per-block partial sums, then mean and rstd
    blocks = K.library().lctvqa_bn_max_blocks()
    scratch = torch.empty(blocks + 1, 2, c, dtype=f32, device=device)
    partial, stat = scratch[:blocks], scratch[blocks]
    BN_FWD.launch(device, x, y, partial, stat, m, c, eps,
                  K.dtype_code(name, x.dtype), K.dtype_code(name, out_dtype))
    return y
