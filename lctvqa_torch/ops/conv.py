"""Convolution and pooling for the VGG19 trunk (port of the parts of
lctvqa/ops/conv.py that VGG19 needs).

Public functions take and return NHWC tensors, as the JAX package's do.
Inside, an NHWC tensor is permuted to an NCHW view with channels-last
strides, which `F.conv2d` and the pools take as it is, so no copy is
made. Conv weights are OIHW (torch's layout; `convert.py` maps the JAX
package's HWIO). These ops are left to cuDNN, as the JAX package leaves
them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

f32 = torch.float32


def torch_conv_init(gen: torch.Generator, kh: int, kw: int, c_in: int,
                    c_out: int, bias: bool = False):
    """OIHW weight U(-k, k), k = 1/sqrt(c_in * kh * kw); bias the same."""
    k = 1.0 / math.sqrt(c_in * kh * kw)
    p = {"w": torch.empty(c_out, c_in, kh, kw, dtype=f32).uniform_(
        -k, k, generator=gen)}
    if bias:
        p["b"] = torch.empty(c_out, dtype=f32).uniform_(-k, k, generator=gen)
    return p


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(params, x: torch.Tensor, stride: int = 1, padding: int = 0,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NHWC conv. With a compute dtype the operands are rounded to it, the
    result is produced in it (fp32 accumulation inside), then widened to
    fp32 before the bias: the JAX package's rounding. An fp32 conv stays
    fp32: cuDNN's TF32, on by default, is turned off for it."""
    x, w = _nchw(x), params["w"]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    cudnn = torch.backends.cudnn
    tf32 = cudnn.allow_tf32
    cudnn.allow_tf32 = tf32 and x.dtype != f32
    try:
        y = F.conv2d(x, w, stride=stride, padding=padding).to(f32)
    finally:
        cudnn.allow_tf32 = tf32
    if "b" in params:
        y = y + params["b"].to(f32).view(1, -1, 1, 1)
    return _nhwc(y)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: int = 0) -> torch.Tensor:
    return _nhwc(F.max_pool2d(_nchw(x.to(f32)), window, stride, padding))


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """NHWC adaptive average pool with torch's bin edges (start =
    floor(i*in/out), end = ceil((i+1)*in/out)), the JAX package's."""
    return _nhwc(F.adaptive_avg_pool2d(_nchw(x.to(f32)), out_size))
