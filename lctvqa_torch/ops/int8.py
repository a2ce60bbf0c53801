"""int8 products with exact int32 sums, for the int8 serving path
(`quant.py`): the port's counterpart of the s8 x s8 -> s32 convolution
and dot that the JAX package asks XLA for (`lctvqa/ops/conv.py::conv2d`
and `lctvqa/ops/nn.py::linear` with `preferred_element_type=int32`).
No Pallas kernel is involved there, and none is written here.

- `int8_matmul(a_q, b_q)`: int8 [M, K] @ int8 [K, N] -> int32 [M, N].
  On the card it is `torch._int_mm`, cuBLASLt's GEMM on Hopper's int8
  tensor cores. That call takes M > 16 and K and N multiples of 8, so
  the operands are padded with zero rows and columns, which leave the
  int32 sums as they are, and the result is sliced back.
- `int8_conv2d(x_q, w_q, ...)`: an NHWC int8 activation and an OIHW int8
  weight -> the NHWC int32 convolution. The patch matrix is built in
  int8 from kh*kw strided slices of the zero-padded input, concatenated
  along the channel axis in (i, j, c) order (dilation moves the slices'
  offsets), then multiplied by the weight as an [kh*kw*C, O] matrix:
  `F.unfold`'s CUDA kernel takes only float types. The matrix is kh*kw
  times the input's bytes (`patch_bytes`); an implicit-GEMM kernel that
  reads the input once is a later change.

The plain versions (`*_plain`, what the wrappers run on a CPU tensor)
compute in float64, which is exact here: every product of two codes is
at most 127^2 and every sum of K of them at most 127^2 K, far inside
2^53 for any K a model has, so they equal int32 accumulation bit for bit
in any order of summation, on either device. A CUDA tensor takes the
card's route or raises; nothing falls back. `LAUNCHES` counts the card's
calls of each wrapper.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

IntOrPair = Union[int, Tuple[int, int]]

# the card's calls of each wrapper (a conv's GEMM counts in int8_matmul too)
LAUNCHES: Dict[str, int] = {"int8_matmul": 0, "int8_conv2d": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _pair(v: IntOrPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _check_int8(name: str, **tensors: torch.Tensor) -> torch.device:
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on {sorted(map(str, devices))}")
    for k, t in tensors.items():
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: {k} is {t.dtype}, not torch.int8")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def int8_matmul_plain(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], exactly (float64)."""
    return (a_q.double() @ b_q.double()).to(torch.int32)


def _up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def int8_matmul(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], exact. A CPU tensor
    takes the plain version; a CUDA tensor `torch._int_mm` on operands
    padded to its shapes (M > 16, K and N multiples of 8)."""
    device = _check_int8("int8_matmul", a_q=a_q, b_q=b_q)
    if a_q.dim() != 2 or b_q.dim() != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(a_q.shape)} and "
                         f"{tuple(b_q.shape)}")
    if device.type == "cpu":
        return int8_matmul_plain(a_q, b_q)
    (m, k), n = a_q.shape, b_q.shape[1]
    mp, kp, np_ = max(m, 17), _up(k, 8), _up(n, 8)
    if (mp, kp) != (m, k):
        a_q = F.pad(a_q, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):  # padded column-major, as weight_matrix lays it
        b_q = F.pad(b_q.t(), (0, kp - k, 0, np_ - n)).t()
    LAUNCHES["int8_matmul"] += 1
    out = torch._int_mm(a_q, b_q)
    return out if (mp, np_) == (m, n) else out[:m, :n]


def conv_out_size(size: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (size + 2 * pad - dil * (k - 1) - 1) // stride + 1


def patches(x_q: torch.Tensor, kh: int, kw: int, stride: IntOrPair = 1,
            padding: IntOrPair = 0, dilation: IntOrPair = 1) -> torch.Tensor:
    """NHWC [B, H, W, C] -> the patch matrix [B, Ho, Wo, kh*kw*C] in x's
    dtype, its last axis in (i, j, c) order; symmetric zero padding."""
    (sh, sw), (ph, pw), (dh, dw) = (_pair(stride), _pair(padding),
                                    _pair(dilation))
    b, h, w, _ = x_q.shape
    ho, wo = (conv_out_size(h, kh, sh, ph, dh),
              conv_out_size(w, kw, sw, pw, dw))
    if ph or pw:
        x_q = F.pad(x_q, (0, 0, pw, pw, ph, ph))
    cols = [x_q[:, i * dh:i * dh + sh * (ho - 1) + 1:sh,
                j * dw:j * dw + sw * (wo - 1) + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=3) if len(cols) > 1 else cols[0]


def patch_bytes(x_shape, kh: int, kw: int, stride: IntOrPair = 1,
                padding: IntOrPair = 0, dilation: IntOrPair = 1) -> int:
    """Bytes of the int8 patch matrix `patches` builds for an NHWC input
    of `x_shape`."""
    (sh, sw), (ph, pw), (dh, dw) = (_pair(stride), _pair(padding),
                                    _pair(dilation))
    b, h, w, c = x_shape
    return (b * conv_out_size(h, kh, sh, ph, dh)
            * conv_out_size(w, kw, sw, pw, dw) * kh * kw * c)


def weight_matrix(w_q: torch.Tensor) -> torch.Tensor:
    """OIHW int8 weight -> the [kh*kw*I, O] matrix of `patches`' order,
    column-major (each output channel's K values contiguous: the
    operand layout cuBLASLt's int8 GEMM takes as it is)."""
    o = w_q.shape[0]
    return w_q.permute(0, 2, 3, 1).reshape(o, -1).t()


def _conv(x_q, w_q, stride, padding, dilation, matmul) -> torch.Tensor:
    if x_q.dim() != 4 or w_q.dim() != 4 or x_q.shape[3] != w_q.shape[1]:
        raise ValueError(f"int8_conv2d: NHWC input {tuple(x_q.shape)} and "
                         f"OIHW weight {tuple(w_q.shape)}")
    kh, kw = w_q.shape[2:]
    p = patches(x_q, kh, kw, stride, padding, dilation)
    b, ho, wo, k = p.shape
    y = matmul(p.reshape(b * ho * wo, k), weight_matrix(w_q))
    return y.reshape(b, ho, wo, w_q.shape[0])


def int8_conv2d_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                      stride: IntOrPair = 1, padding: IntOrPair = 0,
                      dilation: IntOrPair = 1) -> torch.Tensor:
    """NHWC int8 x, OIHW int8 w -> NHWC int32, exactly (float64)."""
    return _conv(x_q, w_q, stride, padding, dilation, int8_matmul_plain)


def int8_conv2d(x_q: torch.Tensor, w_q: torch.Tensor, stride: IntOrPair = 1,
                padding: IntOrPair = 0,
                dilation: IntOrPair = 1) -> torch.Tensor:
    """NHWC int8 x [B, H, W, C], OIHW int8 w [O, C, kh, kw] -> NHWC int32
    [B, Ho, Wo, O], exact; symmetric zero padding, one group. A CPU
    tensor takes the plain version; a CUDA tensor the int8 patch matrix
    and `int8_matmul`."""
    device = _check_int8("int8_conv2d", x_q=x_q, w_q=w_q)
    if device.type == "cpu":
        return int8_conv2d_plain(x_q, w_q, stride, padding, dilation)
    LAUNCHES["int8_conv2d"] += 1
    return _conv(x_q, w_q, stride, padding, dilation, int8_matmul)
