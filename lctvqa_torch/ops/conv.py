"""Convolution, pooling and normalization in NHWC (port of
lctvqa/ops/conv.py).

Public functions take and return NHWC tensors, as the JAX package's do.
Inside, an NHWC tensor is permuted to an NCHW view with channels-last
strides, which `F.conv2d` and the pools take as it is, so no copy is
made. Conv weights are OIHW (torch's layout; `convert.py` maps the JAX
package's HWIO, a depthwise [k, k, 1, C] to [C, 1, k, k]). Convolutions
and pools are left to cuDNN, as the JAX package leaves them to XLA.

BatchNorm is batch-statistics everywhere, as in the JAX package by
default, over the global batch under data parallelism (the sums of every
rank's rows, `cuda_bn.batch_moments`); the `bn_capture`/`bn_eval`
contexts reproduce a reference run's eval-mode running statistics when
asked. Affine-free BatchNorm of a CUDA
tensor goes through the BatchNorm kernels (`ops/cuda_bn.py`, forward and
backward) when `USE_PALLAS_BN` is on, except under either context; so
does a CPU tensor's call that needs no gradient, outside a process
group: it is the `batchnorm` operator, whose CPU implementation is the
plain version, which every other CPU call takes here.

The `second_order` context is for code that differentiates a gradient
(the architects of stage 3): in it `batchnorm` takes the plain route
whatever `USE_PALLAS_BN` says, and an fp32 convolution on the card is a
plain `F.conv2d` under cuDNN without TF32, since `_ExactConvFn`'s
backward cannot be differentiated again.

int8 serving (`quant.py`): `quantize_weight`, `quantize_act` and
`quantize_conv_params` are the JAX package's, and `conv2d` takes params
holding "w_q" through the int8 products of `ops/int8.py`.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from lctvqa_torch.ops import cuda_bn, int8
from lctvqa_torch.parallel import distributed

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


_Q_EPS = 1e-12


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(abs-max, 1e-12) / 127, a division on either device: PyTorch's
    CUDA division by a Python number multiplies by its reciprocal, an ulp
    away, so the divisor is a tensor on absmax's device."""
    return torch.clamp_min(absmax, _Q_EPS) / absmax.new_full((), 127.0)


def quantize_weight(w: torch.Tensor, out_axis: int):
    """fp32 weight -> (int8 weight, fp32 scale per output channel):
    symmetric, each channel's abs-max mapped to +/-127. The JAX package's
    order of operations (lctvqa/ops/conv.py), so the codes are its: the
    scale max(abs-max, 1e-12) / 127, then w / scale (a division, not a
    product with the reciprocal), rounded half to even, clipped."""
    axes = tuple(i for i in range(w.dim()) if i != out_axis)
    s = _scale(w.abs().amax(dim=axes))
    shape = [1] * w.dim()
    shape[out_axis] = -1
    q = torch.clamp(torch.round(w / s.reshape(shape)), -127, 127)
    return q.to(torch.int8), s.to(f32)


def quantize_act(x: torch.Tensor, per_sample: bool = False):
    """fp activation -> (int8 activation, fp32 scale), dynamic abs-max,
    computed per call; `per_sample` keeps one scale per leading-axis
    sample (shape [N, 1, ...]) so that one outlier sample does not
    flatten the others' grid. x is cast to fp32 first."""
    x = x.to(f32)
    if per_sample:
        s = _scale(x.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True))
    else:
        s = _scale(x.abs().amax())
    q = torch.clamp(torch.round(x / s), -127, 127)
    return q.to(torch.int8), s


def quantize_conv_params(p):
    """{"w"[, "b"]} conv params (OIHW) -> {"w_q", "w_s"[, "b"]}: `conv2d`
    dispatches on the "w_q" key (serving only: no derivative)."""
    wq, ws = quantize_weight(p["w"], out_axis=0)
    out = {"w_q": wq, "w_s": ws}
    if "b" in p:
        out["b"] = p["b"]
    return out


def _conv2d_int8(params, x: torch.Tensor, stride, padding, dilation,
                 groups: int, out_dtype) -> torch.Tensor:
    """The int8 route of `conv2d`: per-sample int8 activations, int8
    weights, int32 sums (ops/int8.py), then y * (sx * w_s) + b in fp32,
    cast to `out_dtype` (default fp32), as the JAX package computes it."""
    if groups != 1:
        raise ValueError("an int8 convolution has one group; a depthwise "
                         "conv stays unquantized")
    xq, sx = quantize_act(x, per_sample=True)
    y = int8.int8_conv2d(xq, params["w_q"], stride, padding, dilation)
    y = y.to(f32) * (sx * params["w_s"])
    if "b" in params:
        y = y + params["b"]
    return y.to(out_dtype or f32)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _pair(v: IntOrPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


@contextlib.contextmanager
def _no_tf32():
    cudnn = torch.backends.cudnn
    was, cudnn.allow_tf32 = cudnn.allow_tf32, False
    try:
        yield
    finally:
        cudnn.allow_tf32 = was


class _ExactConvFn(torch.autograd.Function):
    """An fp32 convolution on the card with cuDNN's TF32, on by default,
    turned off in the forward and in the backward: autograd runs the
    backward later, outside any setting the forward made. First order
    only."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.args = (stride, padding, dilation, groups)
        with _no_tf32():
            return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.args
        with _no_tf32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, dilation, False, (0, 0),
                groups, (ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False))
        return dx, dw, None, None, None, None


_SECOND_ORDER: contextvars.ContextVar = contextvars.ContextVar(
    "lctvqa_torch_second_order", default=False)


@contextlib.contextmanager
def second_order():
    """Twice-differentiable routes in the scope: the plain BatchNorm, and
    fp32 convolutions as plain `F.conv2d` with cuDNN's TF32 off. The TF32
    switch is process-wide, so a backward that autograd runs later on
    another thread still sees it off as long as the scope is open: open
    it around the whole differentiation, not only around the forward."""
    tok = _SECOND_ORDER.set(True)
    try:
        with _no_tf32():
            yield
    finally:
        _SECOND_ORDER.reset(tok)


def in_second_order() -> bool:
    """Whether a `second_order` scope is open."""
    return _SECOND_ORDER.get()


class _SecondOrderAgain:
    """The `second_order` scope a forward ran in, entered again (or not)
    at each recomputation of it."""

    def __init__(self):
        self.on = _SECOND_ORDER.get()
        self.open = []

    def __enter__(self):
        scope = second_order() if self.on else contextlib.nullcontext()
        scope.__enter__()
        self.open.append(scope)

    def __exit__(self, *exc):
        return self.open.pop().__exit__(*exc)


def checkpoint_contexts():
    """`context_fn` of `torch.utils.checkpoint` (use_reentrant=False): the
    recomputation of a forward, which autograd may run on another thread
    than the forward's, takes the routes the forward took (`second_order`
    is a context variable, which does not follow autograd's threads)."""
    return contextlib.nullcontext(), _SecondOrderAgain()


def conv2d(params, x: torch.Tensor, stride: IntOrPair = 1,
           padding: IntOrPair = 0, dilation: IntOrPair = 1, groups: int = 1,
           dtype: Optional[torch.dtype] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """NHWC conv; `stride`, `padding` (symmetric) and `dilation` are ints
    or (h, w) pairs. With a compute dtype the operands are rounded to it
    and the result is produced in it (fp32 accumulation inside), then
    cast to `out_dtype` (default fp32) before the bias: the JAX package's
    rounding. An fp32 conv stays fp32: cuDNN's TF32, on by default, is
    turned off for it, forward and backward (first order only, except
    under `second_order`).

    Quantized params (`quantize_conv_params`) take the int8 route: the
    compute dtype is ignored there, as in the JAX package, and there is
    no derivative."""
    if "w_q" in params:
        return _conv2d_int8(params, x, stride, padding, dilation, groups,
                            out_dtype)
    x, w = _nchw(x), params["w"]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    out_dtype = out_dtype or f32
    if (x.device.type == "cpu" and w.shape[2:] == (1, 1)
            and stride not in (1, (1, 1))):
        # oneDNN's weight gradient of a strided 1x1 convolution corrupts
        # the heap on a channels-last input of few channels (8 -> 4 at 64
        # pixels, the factorized reduce of a reduction cell; PyTorch 2.11
        # and 2.13): hand it an NCHW-contiguous input
        x = x.contiguous()
    if (x.dtype == f32 and x.device.type == "cuda"
            and not _SECOND_ORDER.get()):
        y = _ExactConvFn.apply(x, w, _pair(stride), _pair(padding),
                               _pair(dilation), groups).to(out_dtype)
    elif x.device.type == "cpu" and x.dtype in (torch.bfloat16,
                                                torch.float16):
        # PyTorch's CPU convolutions of 16-bit operands do not all sum in
        # fp32: a dilated depthwise one's weight gradient is summed in
        # bf16 (28% off over 8 x 32 x 32 rows, PyTorch 2.13). The rounded
        # operands' product in fp32, rounded to their dtype, is what the
        # card computes, forward and backward
        y = F.conv2d(x.to(f32), w.to(f32), stride=stride, padding=padding,
                     dilation=dilation, groups=groups).to(x.dtype).to(
                         out_dtype)
    else:
        y = F.conv2d(x, w, stride=stride, padding=padding, dilation=dilation,
                     groups=groups).to(out_dtype)
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


# ---------------------------------------------------------------------------
# Running statistics (opt-in, `ModelConfig.bn_eval_stats`). An ambient
# context gates each `batchnorm` call:
#   - `with bn_capture() as cap:` batch-stat math as usual, and every call
#     appends its {"mean", "var"} to `cap.stats`, the variance already
#     unbiased by n / (n - 1), as its only reader is the running update;
#   - `update_running_stats(running, cap.stats)` is torch's momentum update
#     (0.1), `init_running_stats` torch's (0, 1) start;
#   - `with bn_eval(running):` each call takes the next entry in call order
#     and normalizes with it, and leaving the context raises if the number
#     of calls and of entries differ.
# Under either context `batchnorm` takes the plain path, never the kernel.
# ---------------------------------------------------------------------------

_BN_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "lctvqa_torch_bn_ctx", default=None)


class _BNCtx:
    __slots__ = ("mode", "stats", "cursor")

    def __init__(self, mode, stats=None):
        self.mode = mode              # 'capture' | 'eval'
        self.stats = list(stats) if stats is not None else []
        self.cursor = 0


@contextlib.contextmanager
def bn_capture():
    """Collect the batch statistics of every `batchnorm` in the scope."""
    ctx = _BNCtx("capture")
    tok = _BN_CTX.set(ctx)
    try:
        yield ctx
    finally:
        _BN_CTX.reset(tok)


@contextlib.contextmanager
def bn_eval(stats):
    """Serve running statistics to `batchnorm` calls, one entry per call in
    call order. Raises if the calls and the entries differ in number."""
    ctx = _BNCtx("eval", stats)
    tok = _BN_CTX.set(ctx)
    try:
        yield ctx
    finally:
        _BN_CTX.reset(tok)
    if ctx.cursor != len(ctx.stats):
        raise ValueError(
            f"bn_eval consumed {ctx.cursor} of {len(ctx.stats)} BN stat "
            "entries: the captured and the evaluated networks differ")


def init_running_stats(captured):
    """torch BatchNorm's start: running mean 0, running variance 1."""
    return [{"mean": torch.zeros_like(c["mean"]),
             "var": torch.ones_like(c["var"])} for c in captured]


def update_running_stats(running, captured, momentum: float = 0.1):
    """running = (1 - m) * running + m * batch, on the unbiased variance
    the capture recorded."""
    return [{"mean": (1.0 - momentum) * r["mean"] + momentum * c["mean"],
             "var": (1.0 - momentum) * r["var"] + momentum * c["var"]}
            for r, c in zip(running, captured)]


def _batchnorm_ctx(ctx: _BNCtx, params, x, eps, out_dtype):
    x32 = x.to(f32)
    if ctx.mode == "eval":
        if ctx.cursor >= len(ctx.stats):
            raise ValueError("bn_eval ran out of BN stat entries")
        s = ctx.stats[ctx.cursor]
        ctx.cursor += 1
        y = (x32 - s["mean"]) * torch.rsqrt(s["var"] + eps)
    else:
        # the global batch's statistics (cuda_bn.batch_moments)
        mean, sq = cuda_bn.batch_moments(x32, tuple(range(x.dim() - 1)))
        var = sq - mean * mean
        n = float(x.numel() // x.shape[-1]
                  * (distributed.data_world() if distributed.active() else 1))
        ctx.stats.append({"mean": mean.detach(),
                          "var": (var * (n / max(n - 1.0, 1.0))).detach()})
        y = (x32 - mean) * torch.rsqrt(var + eps)
    if "scale" in params:
        y = y * params["scale"] + params["bias"]
    return y if out_dtype is None else y.to(out_dtype)


def batchnorm(params, x: torch.Tensor, eps: float = 1e-5,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Batch-statistics BN over (N, H, W) per channel (the DARTS search
    space runs its BN layers in train mode during search and eval)."""
    ctx = _BN_CTX.get()
    if ctx is not None:
        return _batchnorm_ctx(ctx, params, x, eps, out_dtype)
    if (USE_PALLAS_BN and not params and x.dim() == 4 and eps == 1e-5
            and not _SECOND_ORDER.get() and (
                x.device.type != "cpu" or not (
                    distributed.active()
                    or (x.requires_grad and torch.is_grad_enabled())))):
        # a CPU tensor only where the plain version runs as the operator:
        # one that needs a gradient, or under a process group, takes the
        # plain route below, with autograd, as it always has
        return cuda_bn.batchnorm_fwd(x, out_dtype=out_dtype)
    return batchnorm_plain(params, x, eps, out_dtype)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: int = 0) -> torch.Tensor:
    return _nhwc(F.max_pool2d(_nchw(x.to(f32)), window, stride, padding))


class _AvgPoolFn(torch.autograd.Function):
    """F.avg_pool2d on a channels-last view, with its gradient taken on
    NCHW-contiguous tensors. PyTorch 2.11's CUDA avg_pool2d backward
    returns a shifted gradient when its tensors are channels-last (the
    forward, and max and adaptive pooling, are right); on contiguous ones
    it agrees with the CPU. The backward is itself differentiable: its
    derivative is an avg_pool2d forward of the incoming gradient."""

    @staticmethod
    def forward(ctx, x, window, stride, padding, count_include_pad):
        ctx.args = (x.shape, window, stride, padding, count_include_pad)
        return F.avg_pool2d(x, window, stride, padding,
                            count_include_pad=count_include_pad)

    @staticmethod
    def backward(ctx, g):
        shape, window, stride, padding, count_include_pad = ctx.args
        like = torch.empty(shape, dtype=g.dtype, device=g.device)
        dx = torch.ops.aten.avg_pool2d_backward(
            g.contiguous(), like, [window, window], [stride, stride],
            [padding, padding], False, count_include_pad, None)
        return dx, None, None, None, None


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0,
             count_include_pad: bool = False) -> torch.Tensor:
    """Average pool; count_include_pad=False divides by the number of
    valid elements of each window."""
    return _nhwc(_AvgPoolFn.apply(_nchw(x.to(f32)), window, stride, padding,
                                  count_include_pad))


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """NHWC adaptive average pool with torch's bin edges (start =
    floor(i*in/out), end = ceil((i+1)*in/out)), the JAX package's."""
    return _nhwc(F.adaptive_avg_pool2d(_nchw(x.to(f32)), out_size))
