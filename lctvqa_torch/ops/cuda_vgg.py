"""The VGG epilogue: the bias, the ReLU and, where a 2x2 max pool follows,
the pool, after one of VGG19's convolutions, in one pass (the kernel in
`lctvqa_torch/csrc/vgg_epilogue.cu`, its plain version and the operator
that joins them).

It replaces no TPU kernel: the JAX package leaves these to XLA, which
fuses them into its convolutions. The port's convolutions stay cuDNN's,
and the composition after each (`ops/conv.py::conv2d`'s cast to fp32 and
bias, ReLU in fp32, `max_pool` in fp32, the next convolution's cast) moved
about 28 bytes of device memory an element where this moves 4, or 2.5
pooled. `models/vgg.py::vgg19_features` takes it where no gradient is
needed (`epilogue_route`).

`vgg_epilogue(y, b, pool, out_dtype)` is the operator
`lctvqa_torch::vgg_epilogue` (`_build.define_op`): on a CUDA tensor the
kernel, which raises on what it does not take and never falls back; on a
CPU tensor the plain version. Neither carries a gradient. Its result is
that composition's bit for bit: one fp32 add, ReLU, the max, one rounding
to `out_dtype` at the end, in the same order.
"""

from __future__ import annotations

import torch

from lctvqa_torch.ops import _build as K
from lctvqa_torch.ops import conv

Tensor = torch.Tensor
f32 = torch.float32
VEC = 8  # channels a thread of the kernel owns
MAX_C = VEC * 256  # a block's 256 threads hold one pixel's channels

VGG_EPILOGUE = K.register(K.Kernel(
    "vgg_epilogue", "lctvqa_vgg_epilogue", [K.PTR] * 3 + [K.INT] * 7))


def vgg_epilogue_plain(y: Tensor, b: Tensor, pool: bool,
                       out_dtype: torch.dtype) -> Tensor:
    """relu(f32(y) + b), 2x2 stride-2 max pooled (floor mode) if `pool`,
    cast to `out_dtype`: y [N, H, W, C] NHWC, b fp32 [C]."""
    x = torch.relu(y.to(f32) + b)
    if pool:
        x = conv.max_pool(x, 2, 2)
    return x.to(out_dtype)


def _out_shape(name: str, y: Tensor, b: Tensor, pool: bool,
               out_dtype: torch.dtype):
    K.check(y.dim() == 4, name, f"needs an NHWC [N, H, W, C] tensor, got "
            f"{tuple(y.shape)}")
    n, h, w, c = y.shape
    K.check(tuple(b.shape) == (c,) and b.dtype == f32, name,
            f"needs an fp32 bias of shape ({c},), got {b.dtype} "
            f"{tuple(b.shape)}")
    K.dtype_code(name, y.dtype)
    K.dtype_code(name, out_dtype)
    K.check(not pool or (h >= 2 and w >= 2), name,
            f"a 2x2 pool needs H and W of 2 or more, got {h}x{w}")
    return (n, h // 2, w // 2, c) if pool else (n, h, w, c)


def vgg_epilogue_cuda(y: Tensor, b: Tensor, pool: bool,
                      out_dtype: torch.dtype) -> Tensor:
    """The kernel: one launch, or a ValueError for what it does not take
    (a tensor off the card, another dtype, an fp32 y to a bf16 output,
    which no route asks for, a non-contiguous or unaligned y, C not a
    multiple of 8 or above MAX_C)."""
    name = VGG_EPILOGUE.name
    device = K.check_cuda_tensors(name, y=y, b=b)
    shape = _out_shape(name, y, b, pool, out_dtype)
    K.check(out_dtype in (y.dtype, f32), name,
            f"writes y's dtype or fp32, got {y.dtype} to {out_dtype}")
    c = y.shape[-1]
    K.check(c % VEC == 0 and c <= MAX_C, name,
            f"needs C a multiple of {VEC} up to {MAX_C}, got {c}")
    K.check(y.is_contiguous() and y.data_ptr() % 16 == 0, name,
            "needs a contiguous y on a 16-byte boundary")
    K.check(y.shape[0] * y.shape[1] * y.shape[2] < 2 ** 32, name,
            f"needs fewer than 2^32 pixels, got {tuple(y.shape)}")
    out = torch.empty(shape, dtype=out_dtype, device=device)
    if out.numel() == 0:
        return out
    n, h, w, _ = y.shape
    VGG_EPILOGUE.launch(device, y, b.contiguous(), out, n, h, w, c,
                        int(pool), K.dtype_code(name, y.dtype),
                        K.dtype_code(name, out_dtype))
    return out


def _fake(y: Tensor, b: Tensor, pool: bool,
          out_dtype: torch.dtype) -> Tensor:
    return y.new_empty(_out_shape(VGG_EPILOGUE.name, y, b, pool, out_dtype),
                       dtype=out_dtype)


VGG_EPILOGUE_OP = K.define_op(
    "vgg_epilogue(Tensor y, Tensor b, bool pool, ScalarType out_dtype) "
    "-> Tensor", vgg_epilogue_cuda, vgg_epilogue_plain, _fake)


def vgg_epilogue(y: Tensor, b: Tensor, pool: bool,
                 out_dtype: torch.dtype) -> Tensor:
    """The epilogue of one VGG convolution (the operator): y the raw
    convolution [N, H, W, C], fp32 or bf16; b fp32 [C] -> relu(f32(y) + b),
    pooled 2x2 if `pool`, in `out_dtype` (y's dtype or fp32). No
    gradient."""
    return VGG_EPILOGUE_OP(y, b, pool, out_dtype)
