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
gives way to the plain version: the kernels take any M and any C up to
thousands of channels.

Each kernel call is a memset of a barrier counter and one cooperative
launch of a persistent grid that stages its rows of the tensor in shared
memory across one grid barrier (bn.cu). Its launch shape comes from
`bn_plan`, the Python mirror of the C side's choice, cached per shape and
card; the counter, the per-block partials and the forward's stat are one
allocation (`bn_scratch`).

Under data parallelism (`parallel/distributed.py`: a process group
exists, of one rank or more) the statistics are the global batch's, as on the JAX
package's mesh, where a BatchNorm's mean is a global-batch mean: each
direction is two launches, a sums launch over this rank's rows and an
apply launch from the sums all-reduced over the ranks between them
(`batchnorm_fwd_stat_sync`, `batchnorm_bwd_sync`; the kernels' grid is
`sync_plan`). Each launch has a plain version (`bn_sums_plain`,
`bn_fwd_apply_plain`, `bn_bwd_sums_plain`, `bn_bwd_apply_plain`), which a
CPU tensor takes. The plain BatchNorm (`batchnorm_stats_plain`,
`batch_moments`) sums its statistics over the ranks the same way, through
a differentiable all-reduce. Without a process group nothing of this
runs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from lctvqa_torch.ops import _build as K
from lctvqa_torch.parallel import distributed

Tensor = torch.Tensor
f32 = torch.float32
EPS = 1e-5

BN_FWD = K.register(K.Kernel(
    "bn_fwd", "lctvqa_bn_fwd",
    [K.PTR] * 4 + [K.INT, ctypes.c_longlong, K.INT, ctypes.c_float, K.INT,
                   K.INT]))
BN_BWD = K.register(K.Kernel(
    "bn_bwd", "lctvqa_bn_bwd",
    [K.PTR] * 5 + [K.INT, ctypes.c_longlong, K.INT, K.INT, K.INT]))
# the two-launch mode of several ranks
BN_FWD_SUMS = K.register(K.Kernel(
    "bn_fwd_sums", "lctvqa_bn_fwd_sums",
    [K.PTR] * 3 + [K.INT, K.LONG, K.INT, K.INT]))
BN_FWD_APPLY = K.register(K.Kernel(
    "bn_fwd_apply", "lctvqa_bn_fwd_apply",
    [K.PTR] * 4 + [K.INT, K.LONG, K.INT, K.LONG, ctypes.c_float, K.INT,
                   K.INT]))
BN_BWD_SUMS = K.register(K.Kernel(
    "bn_bwd_sums", "lctvqa_bn_bwd_sums",
    [K.PTR] * 5 + [K.INT, K.LONG, K.INT, K.INT, K.INT]))
BN_BWD_APPLY = K.register(K.Kernel(
    "bn_bwd_apply", "lctvqa_bn_bwd_apply",
    [K.PTR] * 5 + [K.INT, K.LONG, K.INT, K.LONG, K.INT, K.INT]))

# bn.cu's constants: threads a block where the whole share is staged and
# where it is not, bulk copies of the staging (an 8-byte mbarrier each),
# bytes of the tensor a block takes, the barrier counter's bytes before the
# partials
FEW_THREADS, MANY_THREADS = 256, 512
STAGES = 4
BLOCK_BYTES = 16384
SYNC_BYTES = 16
# the two-launch mode's threads a block and blocks an SM at most
SYNC_THREADS = 256
SYNC_BLOCKS_PER_SM = 4
# an H100 SXM's SMs and the shared memory a block may opt into
H100_SMS = 132
SMEM_PER_BLOCK = 232448
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def batch_moments(x32: Tensor, axes) -> Tuple[Tensor, Tensor]:
    """Per channel (the last axis), the mean of x32 and of its square over
    `axes` of the global batch: over this tensor without a process group;
    with one, their sums all-reduced over the data group (differentiably,
    so that a gradient reaches every rank's rows) over the global count
    (equal shares)."""
    if not distributed.active():
        return x32.mean(axes), (x32 * x32).mean(axes)
    count = x32.numel() // x32.shape[-1] * distributed.data_world()
    s = distributed.all_reduce_sum(
        torch.stack([x32.sum(axes), (x32 * x32).sum(axes)]))
    return s[0] / count, s[1] / count


def batchnorm_stats_plain(x: Tensor, eps: float = EPS) -> Tensor:
    """x [..., C] -> stat [2, C] fp32: mean and 1/sqrt(var + eps), over
    the global batch (`batch_moments`)."""
    mean, sq = batch_moments(x.to(f32), tuple(range(x.dim() - 1)))
    var = sq - mean * mean
    return torch.stack([mean, torch.rsqrt(var + eps)])


def batchnorm_plain(x: Tensor, eps: float = EPS,
                    out_dtype: Optional[torch.dtype] = None) -> Tensor:
    """x [..., C] -> normalized, fp32 unless `out_dtype` is given."""
    mean, rstd = batchnorm_stats_plain(x, eps)
    y = (x.to(f32) - mean) * rstd
    return y if out_dtype is None else y.to(out_dtype)


def batchnorm_bwd_plain(x: Tensor, g: Tensor, stat: Tensor) -> Tensor:
    """The gradient of `batchnorm_plain` w.r.t. x given the output's
    gradient g and the forward's `stat`; in x's dtype. One rank's batch
    only: several ranks take `batchnorm_bwd_sync`."""
    axes = tuple(range(x.dim() - 1))
    mean, rstd = stat
    g32 = g.to(f32)
    xhat = (x.to(f32) - mean) * rstd
    dx = rstd * (g32 - g32.mean(axes) - xhat * (g32 * xhat).mean(axes))
    return dx.to(x.dtype)


# the plain versions of the two-launch mode's kernels, on [..., C] tensors

def bn_sums_plain(x: Tensor) -> Tensor:
    """-> fp32 [2, C]: the sums of x and of x^2 over this rank's rows."""
    x32 = x.to(f32).reshape(-1, x.shape[-1])
    return torch.stack([x32.sum(0), (x32 * x32).sum(0)])


def bn_fwd_apply_plain(x: Tensor, sums: Tensor, count: int,
                       out_dtype: Optional[torch.dtype] = None,
                       eps: float = EPS) -> Tuple[Tensor, Tensor]:
    """-> (y in `out_dtype`, default fp32; stat [2, C]) from the sums of
    `count` rows (every rank's), the kernel's arithmetic: mean = sum *
    (1 / count) in fp32."""
    inv = torch.tensor(1.0 / count, dtype=f32, device=x.device)
    mean = sums[0] * inv
    rstd = 1.0 / torch.sqrt(sums[1] * inv - mean * mean + eps)
    y = (x.to(f32) - mean) * rstd
    return (y if out_dtype is None else y.to(out_dtype),
            torch.stack([mean, rstd]))


def bn_bwd_sums_plain(x: Tensor, g: Tensor, stat: Tensor) -> Tensor:
    """-> fp32 [2, C]: the sums of g and of g * xhat over this rank's
    rows, xhat from the forward's stat."""
    c = x.shape[-1]
    g32 = g.to(f32).reshape(-1, c)
    xhat = (x.to(f32).reshape(-1, c) - stat[0]) * stat[1]
    return torch.stack([g32.sum(0), (g32 * xhat).sum(0)])


def bn_bwd_apply_plain(x: Tensor, g: Tensor, stat: Tensor, sums: Tensor,
                       count: int) -> Tensor:
    """dx = rstd * (g - sum g / count - xhat * sum g xhat / count), in x's
    dtype."""
    inv = torch.tensor(1.0 / count, dtype=f32, device=x.device)
    mean, rstd = stat
    xhat = (x.to(f32) - mean) * rstd
    dx = rstd * (g.to(f32) - sums[0] * inv - xhat * (sums[1] * inv))
    return dx.to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _plan_at(m: int, c: int, ex: int, eg: int, threads: int, sm_count: int,
             smem_max: int) -> dict:
    """`bn_plan` at `threads` threads a block, for x of `ex` bytes an
    element and g of `eg` (0 in the forward): bn.cu's make_plan_at."""
    vec = 4 if c % 4 == 0 else 1
    groups = c // vec
    lanes = 1
    while lanes < groups and lanes < 32:
        lanes *= 2
    red = max(threads // 32 * lanes * 2 * vec, threads)
    fixed = (4 * _round_up(red, 4) + 4 * _round_up((4 if eg else 2) * c, 4)
             + 8 * STAGES)
    unit = 1
    if vec == 4:
        while unit * c * ex % 16 or unit * c * eg % 16:
            unit *= 2
    row_bytes = c * (ex + eg)
    blocks = min(max(-(-m * row_bytes // BLOCK_BYTES), 1), sm_count)
    rows = _round_up(-(-m // blocks), unit)
    blocks = -(-m // rows)
    room = smem_max - fixed - 32
    if room < 0:
        raise ValueError(f"bn: C={c} too large: the statistics need "
                         f"{fixed} bytes of shared memory, a block has "
                         f"{smem_max}")
    staged = min(rows, room // row_bytes // unit * unit)
    smem = (_round_up(staged * c * ex, 16) + _round_up(staged * c * eg, 16)
            + fixed)
    return {"blocks": blocks, "threads": threads, "rows": rows,
            "staged": staged, "smem_bytes": smem, "vec": vec, "lanes": lanes}


@functools.lru_cache(maxsize=1024)
def bn_plan(m: int, c: int, x_dtype: torch.dtype, out_dtype: torch.dtype,
            backward: bool = False, sm_count: int = H100_SMS,
            smem_max: int = SMEM_PER_BLOCK) -> dict:
    """The launch shape of the forward kernel (backward=False; out_dtype is
    y's dtype, which does not change it) or the backward kernel (out_dtype
    is g's dtype) over an [m, c] tensor on a card of `sm_count` SMs and
    `smem_max` bytes of shared memory a block, as bn.cu's make_plan chooses
    it: a block per 16 KiB of the tensor (x, and g in the backward), at
    most one an SM; each block's share a whole number of rows that starts
    on 16 bytes; as many of them staged in shared memory as fit beside the
    reduction scratch (warps x lanes x 2 VEC floats, at least a float a
    thread), the statistics (2 C floats, 4 C in the backward) and the
    staging's STAGES mbarriers; FEW_THREADS threads a block where that
    stages every row, else MANY_THREADS. -> {"blocks", "threads", "rows" (a
    block's share), "staged", "smem_bytes", "vec", "lanes"}. Raises
    ValueError where the statistics alone do not fit."""
    ex = _ELEM_BYTES[x_dtype]
    eg = _ELEM_BYTES[out_dtype] if backward else 0
    plan = _plan_at(m, c, ex, eg, FEW_THREADS, sm_count, smem_max)
    if plan["staged"] < plan["rows"]:
        plan = _plan_at(m, c, ex, eg, MANY_THREADS, sm_count, smem_max)
    return plan


def bn_scratch(plan: dict, c: int) -> dict:
    """A call's one allocation, fp32 [rows, C], in bytes: the forward's stat
    [2, C] (mean, 1/sqrt(var + eps)), the barrier's counter, the per-block
    partials [blocks, 2, C]; 16-byte aligned where C is even, which is
    where the kernels read the partials 16 bytes at a time. -> {"counter",
    "partial", "total", "rows"}: byte offsets, the bytes used, the rows of
    C floats that hold them."""
    counter = 8 * c
    total = counter + SYNC_BYTES + plan["blocks"] * 2 * c * 4
    return {"counter": counter, "partial": counter + SYNC_BYTES,
            "total": total, "rows": -(-total // (4 * c))}


@functools.lru_cache(maxsize=None)
def _card(index: int) -> Tuple[int, int]:
    """(SMs, shared memory a block may opt into) of CUDA device `index`."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def bn_plan_on_device(m: int, c: int, x_dtype: torch.dtype,
                      out_dtype: torch.dtype, backward: bool,
                      device: torch.device) -> dict:
    """The launch shape the C entry point takes on `device` (it asks the
    card): `bn_plan`'s keys without vec and lanes."""
    fn = K.library().lctvqa_bn_plan
    fn.argtypes = [ctypes.c_longlong, K.INT, K.INT, K.INT,
                   ctypes.POINTER(K.INT * 5)]
    fn.restype = K.INT
    plan = (K.INT * 5)()
    g_code = K.dtype_code("bn", out_dtype) if backward else -1
    with torch.cuda.device(device):
        rc = fn(m, c, K.dtype_code("bn", x_dtype), g_code, ctypes.byref(plan))
    if rc != 0:
        msg = K.library().lctvqa_cuda_error_string(rc).decode()
        raise RuntimeError(f"bn: no launch shape for M={m}, C={c} on "
                           f"{device}: {msg} (cudaError {rc})")
    return dict(zip(("blocks", "threads", "rows", "staged", "smem_bytes"),
                    plan))


@functools.lru_cache(maxsize=1024)
def sync_plan(m: int, c: int, x_dtype: torch.dtype,
              g_dtype: Optional[torch.dtype] = None,
              sm_count: int = H100_SMS) -> dict:
    """The grid of the two-launch mode's kernels over an [m, c] tensor
    (and g of `g_dtype` in the backward), as bn.cu's make_sync_plan
    chooses it: a block per 16 KiB of the tensor, at most
    SYNC_BLOCKS_PER_SM an SM, each a whole number of rows. -> {"blocks",
    "rows" (a block's), "lanes"}."""
    vec = 4 if c % 4 == 0 else 1
    lanes = 1
    while lanes < c // vec and lanes < 32:
        lanes *= 2
    row_bytes = c * (_ELEM_BYTES[x_dtype]
                     + (_ELEM_BYTES[g_dtype] if g_dtype is not None else 0))
    blocks = min(max(-(-m * row_bytes // BLOCK_BYTES), 1),
                 SYNC_BLOCKS_PER_SM * sm_count)
    rows = -(-m // blocks)
    return {"blocks": -(-m // rows), "rows": rows, "lanes": lanes}


def sync_plan_on_device(m: int, c: int, x_dtype: torch.dtype,
                        g_dtype: Optional[torch.dtype],
                        device: torch.device) -> dict:
    """The grid the C side takes on `device` (it asks the card)."""
    fn = K.library().lctvqa_bn_sync_plan
    fn.argtypes = [ctypes.c_longlong, K.INT, K.INT, K.INT,
                   ctypes.POINTER(K.INT * 3)]
    fn.restype = K.INT
    plan = (K.INT * 3)()
    g_code = K.dtype_code("bn", g_dtype) if g_dtype is not None else -1
    with torch.cuda.device(device):
        rc = fn(m, c, K.dtype_code("bn", x_dtype), g_code, ctypes.byref(plan))
    if rc != 0:
        msg = K.library().lctvqa_cuda_error_string(rc).decode()
        raise RuntimeError(f"bn: no two-launch grid for M={m}, C={c} on "
                           f"{device}: {msg} (cudaError {rc})")
    return dict(zip(("blocks", "rows", "lanes"), plan))


def _aligned(x: Tensor, c: int) -> Tensor:
    x = x.contiguous()
    if c % 4 == 0 and x.data_ptr() % 16:  # the kernels copy 16 bytes
        x = x.clone()
    return x


def _launch_buffer(x: Tensor, c: int, other: torch.dtype, backward: bool):
    """The plan on x's device and the call's one allocation (`bn_scratch`)
    -> (blocks, the allocation [rows, C] fp32, the counter's address)."""
    plan = bn_plan(x.numel() // c, c, x.dtype, other, backward,
                   *_card(x.device.index))
    lay = bn_scratch(plan, c)
    buf = torch.empty((lay["rows"], c), dtype=f32, device=x.device)
    return plan["blocks"], buf, buf.data_ptr() + lay["counter"]


def _check_rows(name: str, x: Tensor, g: Optional[Tensor] = None) -> None:
    if x.dim() < 2 or x.numel() == 0 or (g is not None
                                         and g.shape != x.shape):
        raise ValueError(
            f"{name}: needs a non-empty [..., C] tensor"
            + ("" if g is None else " and a g of its shape") + ", got "
            + f"{tuple(x.shape)}" + ("" if g is None
                                     else f" and {tuple(g.shape)}"))


def _sync_scratch(plan: dict, c: int, device) -> Tensor:
    """The counter (SYNC_BYTES) and the per-block partials [blocks, 2, C]
    of a sums launch, fp32, 16-byte aligned."""
    n = SYNC_BYTES // 4 + plan["blocks"] * 2 * c
    return torch.empty(n, dtype=f32, device=device)


def bn_sums(x: Tensor) -> Tensor:
    """Kernel: the sums of x and x^2 per channel over this rank's rows ->
    fp32 [2, C] (`bn_sums_plain` on the CPU)."""
    if x.device.type == "cpu":
        return bn_sums_plain(x)
    name = BN_FWD_SUMS.name
    if x.device.type != "cuda":
        K.check_cuda_tensors(name, x=x)
    _check_rows(name, x)
    c = x.shape[-1]
    x = _aligned(x, c)
    m = x.numel() // c
    plan = sync_plan(m, c, x.dtype, None, _card(x.device.index)[0])
    sums = torch.empty((2, c), dtype=f32, device=x.device)
    BN_FWD_SUMS.launch(x.device, x, sums, _sync_scratch(plan, c, x.device),
                       plan["blocks"], m, c, K.dtype_code(name, x.dtype))
    return sums


def bn_fwd_apply(x: Tensor, sums: Tensor, count: int,
                 out_dtype: Optional[torch.dtype] = None, eps: float = EPS
                 ) -> Tuple[Tensor, Tensor]:
    """Kernel: y and stat from the sums of `count` rows ->
    (y in `out_dtype`, default fp32; stat fp32 [2, C])."""
    if x.device.type == "cpu":
        return bn_fwd_apply_plain(x, sums, count, out_dtype, eps)
    name = BN_FWD_APPLY.name
    if not (x.device.type == "cuda" and sums.device == x.device):
        K.check_cuda_tensors(name, x=x, sums=sums)
    _check_rows(name, x)
    c = x.shape[-1]
    if sums.shape != (2, c) or sums.dtype != f32 or not sums.is_contiguous():
        raise ValueError(f"{name}: sums must be contiguous fp32 [2, {c}]")
    out_dtype = out_dtype or f32
    x = _aligned(x, c)
    m = x.numel() // c
    plan = sync_plan(m, c, x.dtype, None, _card(x.device.index)[0])
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    stat = torch.empty((2, c), dtype=f32, device=x.device)
    BN_FWD_APPLY.launch(x.device, x, y, sums, stat, plan["blocks"], m, c,
                        count, eps, K.dtype_code(name, x.dtype),
                        K.dtype_code(name, out_dtype))
    return y, stat


def bn_bwd_sums(x: Tensor, g: Tensor, stat: Tensor) -> Tensor:
    """Kernel: the sums of g and g * xhat per channel over this rank's
    rows -> fp32 [2, C]."""
    if x.device.type == "cpu":
        return bn_bwd_sums_plain(x, g, stat)
    name = BN_BWD_SUMS.name
    if not (x.device.type == "cuda" and g.device == x.device
            and stat.device == x.device):
        K.check_cuda_tensors(name, x=x, g=g, stat=stat)
    _check_rows(name, x, g)
    c = x.shape[-1]
    if stat.shape != (2, c) or stat.dtype != f32 or not stat.is_contiguous():
        raise ValueError(f"{name}: stat must be contiguous fp32 [2, {c}]")
    x, g = _aligned(x, c), _aligned(g, c)
    m = x.numel() // c
    plan = sync_plan(m, c, x.dtype, g.dtype, _card(x.device.index)[0])
    sums = torch.empty((2, c), dtype=f32, device=x.device)
    BN_BWD_SUMS.launch(x.device, x, g, stat, sums,
                       _sync_scratch(plan, c, x.device), plan["blocks"], m,
                       c, K.dtype_code(name, x.dtype),
                       K.dtype_code(name, g.dtype))
    return sums


def bn_bwd_apply(x: Tensor, g: Tensor, stat: Tensor, sums: Tensor,
                 count: int) -> Tensor:
    """Kernel: dx from the backward's sums of `count` rows, in x's
    dtype."""
    if x.device.type == "cpu":
        return bn_bwd_apply_plain(x, g, stat, sums, count)
    name = BN_BWD_APPLY.name
    if not (x.device.type == "cuda" and g.device == x.device
            and stat.device == x.device and sums.device == x.device):
        K.check_cuda_tensors(name, x=x, g=g, stat=stat, sums=sums)
    _check_rows(name, x, g)
    c = x.shape[-1]
    for what, t in (("stat", stat), ("sums", sums)):
        if t.shape != (2, c) or t.dtype != f32 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous fp32 "
                             f"[2, {c}]")
    x, g = _aligned(x, c), _aligned(g, c)
    m = x.numel() // c
    plan = sync_plan(m, c, x.dtype, g.dtype, _card(x.device.index)[0])
    dx = torch.empty_like(x)
    BN_BWD_APPLY.launch(x.device, x, g, stat, sums, dx, plan["blocks"], m, c,
                        count, K.dtype_code(name, x.dtype),
                        K.dtype_code(name, g.dtype))
    return dx


def global_sums(sums: Tensor) -> Tensor:
    """This rank's [2, C] sums summed over the data group, in place."""
    torch.distributed.all_reduce(sums, group=distributed.data_group())
    return sums


def batchnorm_fwd_stat_sync(x: Tensor,
                            out_dtype: Optional[torch.dtype] = None,
                            eps: float = EPS
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """`batchnorm_fwd_stat` over the global batch of the data group's
    ranks, each holding an equal share: a sums launch, the all-reduce of
    the sums, an apply launch. -> (y, stat, the x the kernels read)."""
    x = _aligned(x, x.shape[-1]) if x.device.type == "cuda" else x
    count = x.numel() // x.shape[-1] * distributed.data_world()
    y, stat = bn_fwd_apply(x, global_sums(bn_sums(x)), count, out_dtype,
                           eps)
    return y, stat, x


def batchnorm_bwd_sync(x: Tensor, g: Tensor, stat: Tensor) -> Tensor:
    """`batchnorm_bwd` over the global batch: a sums launch, the
    all-reduce, an apply launch."""
    count = x.numel() // x.shape[-1] * distributed.data_world()
    return bn_bwd_apply(x, g, stat, global_sums(bn_bwd_sums(x, g, stat)),
                        count)


def batchnorm_fwd_stat(x: Tensor, out_dtype: Optional[torch.dtype] = None,
                       eps: float = EPS) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (y, stat [2, C], the contiguous x the kernel read). CPU tensors
    take the plain version; data parallelism the two-launch mode."""
    if distributed.active():
        return batchnorm_fwd_stat_sync(x, out_dtype, eps)
    if x.device.type == "cpu":
        stat = batchnorm_stats_plain(x, eps)
        y = (x.to(f32) - stat[0]) * stat[1]
        return (y if out_dtype is None else y.to(out_dtype)), stat, x
    name = BN_FWD.name
    if x.device.type != "cuda":
        K.check_cuda_tensors(name, x=x)
    out_dtype = out_dtype or f32
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"{name}: needs a non-empty [..., C] tensor, got "
                         f"{tuple(x.shape)}")
    in_code = K.dtype_code(name, x.dtype)
    out_code = K.dtype_code(name, out_dtype)
    c = x.shape[-1]
    x = _aligned(x, c)
    blocks, buf, scratch = _launch_buffer(x, c, out_dtype, False)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    stat = buf[:2]
    BN_FWD.launch(x.device, x, y, stat, scratch, blocks, x.numel() // c, c,
                  eps, in_code, out_code)
    return y, stat, x


def batchnorm_bwd(x: Tensor, g: Tensor, stat: Tensor) -> Tensor:
    """dx of the affine-free batch-stat BN (replaces the backward of
    batchnorm_pallas). x [..., C] fp32 or bf16, g of x's shape fp32 or
    bf16, stat [2, C] fp32 from the forward -> dx in x's dtype. Data
    parallelism takes the two-launch mode."""
    if distributed.active():
        return batchnorm_bwd_sync(x, g, stat)
    if x.device.type == "cpu":
        return batchnorm_bwd_plain(x, g, stat)
    name = BN_BWD.name
    if not (x.device.type == "cuda" and g.device == x.device
            and stat.device == x.device):
        K.check_cuda_tensors(name, x=x, g=g, stat=stat)
    c = x.shape[-1]
    if x.dim() < 2 or x.numel() == 0 or g.shape != x.shape:
        raise ValueError(f"{name}: needs x and g of one non-empty [..., C] "
                         f"shape, got {tuple(x.shape)} and {tuple(g.shape)}")
    if stat.shape != (2, c) or stat.dtype != f32 or not stat.is_contiguous():
        raise ValueError(f"{name}: stat must be contiguous fp32 [2, {c}]")
    x_code, g_code = K.dtype_code(name, x.dtype), K.dtype_code(name, g.dtype)
    x, g = _aligned(x, c), _aligned(g, c)
    blocks, buf, scratch = _launch_buffer(x, c, g.dtype, True)
    dx = torch.empty_like(x)
    BN_BWD.launch(x.device, x, g, stat, dx, scratch, blocks, x.numel() // c,
                  c, x_code, g_code)
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
