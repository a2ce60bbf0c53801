"""Convolution, pooling and normalization in NHWC (port of
lctvqa/ops/conv.py).

Public functions take and return NHWC tensors, as the JAX package's do.
Inside, an NHWC tensor is permuted to an NCHW view with channels-last
strides, which `F.conv2d` and the pools take as it is, so no copy is
made. Conv weights are OIHW (torch's layout; `convert.py` maps the JAX
package's HWIO, a depthwise [k, k, 1, C] to [C, 1, k, k]). Convolutions
and pools are left to cuDNN, as the JAX package leaves them to XLA.

BatchNorm is batch-statistics everywhere, as in the JAX package by
default; its `bn_capture`/`bn_eval` running-statistics contexts come with
training. Affine-free BatchNorm of a CUDA tensor goes through the
single-pass kernel's counterpart (`ops/cuda_bn.py`) when `USE_PALLAS_BN`
is on.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from lctvqa_torch.ops import cuda_bn

f32 = torch.float32
IntOrPair = Union[int, Tuple[int, int]]

# Route affine-free batch-stat BNs of CUDA tensors through the BatchNorm
# kernel (ops/cuda_bn.py). A process-wide switch, off by default, like the
# JAX package's of the same name (lctvqa/ops/conv.py): set it before the
# server starts.
USE_PALLAS_BN = False


def torch_conv_init(gen: torch.Generator, kh: int, kw: int, c_in: int,
                    c_out: int, groups: int = 1, bias: bool = False):
    """OIHW weight U(-k, k), k = 1/sqrt(fan_in), fan_in =
    (c_in/groups)*kh*kw; bias the same."""
    k = 1.0 / math.sqrt((c_in // groups) * kh * kw)
    p = {"w": torch.empty(c_out, c_in // groups, kh, kw, dtype=f32).uniform_(
        -k, k, generator=gen)}
    if bias:
        p["b"] = torch.empty(c_out, dtype=f32).uniform_(-k, k, generator=gen)
    return p


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(params, x: torch.Tensor, stride: IntOrPair = 1,
           padding: IntOrPair = 0, dilation: IntOrPair = 1, groups: int = 1,
           dtype: Optional[torch.dtype] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NHWC conv; `stride`, `padding` (symmetric) and `dilation` are ints
    or (h, w) pairs. With a compute dtype the operands are rounded to it
    and the result is produced in it (fp32 accumulation inside), then
    cast to `out_dtype` (default fp32) before the bias: the JAX package's
    rounding. An fp32 conv stays fp32: cuDNN's TF32, on by default, is
    turned off for it."""
    x, w = _nchw(x), params["w"]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    out_dtype = out_dtype or f32
    cudnn = torch.backends.cudnn
    tf32 = cudnn.allow_tf32
    cudnn.allow_tf32 = tf32 and x.dtype != f32
    try:
        y = F.conv2d(x, w, stride=stride, padding=padding, dilation=dilation,
                     groups=groups).to(out_dtype)
    finally:
        cudnn.allow_tf32 = tf32
    if "b" in params:
        y = y + params["b"].to(out_dtype).view(1, -1, 1, 1)
    return _nhwc(y)


def depthwise_conv2d(params, x: torch.Tensor, stride: IntOrPair = 1,
                     padding: IntOrPair = 0, dilation: IntOrPair = 1,
                     dtype: Optional[torch.dtype] = None,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Depthwise conv: weight [C, 1, kh, kw], groups = C."""
    return conv2d(params, x, stride, padding, dilation, groups=x.shape[-1],
                  dtype=dtype, out_dtype=out_dtype)


def batchnorm_init(c: int, affine: bool = True):
    if affine:
        return {"scale": torch.ones(c, dtype=f32),
                "bias": torch.zeros(c, dtype=f32)}
    return {}


def batchnorm_plain(params, x: torch.Tensor, eps: float = 1e-5,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain two-pass BN: stats and normalize in fp32, variance as
    E[x^2] - mean^2, optional scale/bias, result cast to `out_dtype`
    (default fp32)."""
    if "scale" not in params:
        return cuda_bn.batchnorm_plain(x, eps, out_dtype)
    y = cuda_bn.batchnorm_plain(x, eps) * params["scale"] + params["bias"]
    return y if out_dtype is None else y.to(out_dtype)


def batchnorm(params, x: torch.Tensor, eps: float = 1e-5,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Batch-statistics BN over (N, H, W) per channel (the DARTS search
    space runs its BN layers in train mode during search and eval)."""
    if (USE_PALLAS_BN and not params and x.dim() == 4 and eps == 1e-5
            and x.device.type != "cpu"):
        return cuda_bn.batchnorm_fwd(x, out_dtype=out_dtype)
    return batchnorm_plain(params, x, eps, out_dtype)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: int = 0) -> torch.Tensor:
    return _nhwc(F.max_pool2d(_nchw(x.to(f32)), window, stride, padding))


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0,
             count_include_pad: bool = False) -> torch.Tensor:
    """Average pool; count_include_pad=False divides by the number of
    valid elements of each window."""
    return _nhwc(F.avg_pool2d(_nchw(x.to(f32)), window, stride, padding,
                              count_include_pad=count_include_pad))


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """NHWC adaptive average pool with torch's bin edges (start =
    floor(i*in/out), end = ceil((i+1)*in/out)), the JAX package's."""
    return _nhwc(F.adaptive_avg_pool2d(_nchw(x.to(f32)), out_size))
