"""The node-batched PC-DARTS mixed op, forward and backward: the two
kernels, their plain versions and the autograd function that joins them.

Counterpart of `lctvqa/ops/pallas_mixedop.py::mixed_node_pallas_hwcn`
and its `custom_vjp`; the kernels are in `lctvqa_torch/csrc/mixedop.cu`.
For the E stride-1 edges of one cell node, on the first Cs channels of
each edge's NHWC state, both versions compute

    out = sum_e w[e, skip] * x_e + sum_e sum_op w[e, op] * BN_op(op(x_e))

with every op's final affine-free batch-stat BN folded into the
coefficients (`coef = w * rsqrt(var + eps)`, minus `sum coef * mean`).
`weights` is [E, 8] in PRIMITIVES order, typically beta_e *
softmax(alpha_e), so that the edge sum is the cell node's beta-weighted
sum. Rounding points are the Pallas kernel's: the inputs of a depthwise
stage are values of the compute dtype (that of the edge states), the
depthwise and pointwise sums are fp32 with unrounded fp32 weights, each
stage output is rounded to the compute dtype once, statistics and the
fold are fp32 over the rounded values, the result is fp32.

The backward gives the gradient w.r.t. every edge state (in the compute
dtype), every edge's packed depthwise taps and pointwise matrices and
`weights` (fp32); the gradients of the conv leaves and of alpha and beta
follow by autograd through `node_weights` and the `beta * softmax(alpha)`
product. The forward kernel leaves every stage output and its statistics
in device memory, and `MixedNodeFn` keeps them for the backward kernel
instead of recomputing them as the TPU kernel must: SLOTS x E x Cs x
N*H*W values of the compute dtype per call. The plain version of the
backward is autograd through `mixed_node_plain`. First order only.

The wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernels or raises. It takes any N >= 1 and any
H, W: the only condition on an edge is stride 1.

Under data parallelism (a process group, `parallel/distributed.py`) every
batch statistic of the node is the global batch's, as on the JAX
package's mesh. The plain version takes its moments through
`cuda_bn.batch_moments`, whose all-reduce is differentiable, so its
backward stays autograd through it. The kernels run in their
data-parallel mode (`node_fwd_sync`, `node_bwd_sync`, each call a
`SyncForward` / `SyncBackward`): one entry point a launch, the edge's
last block writing this rank's sums where the one-process kernel
finishes the statistics, and the sums all-reduced over the data group
between the launches: A, all-reduce, B, all-reduce, Z forward; R,
all-reduce, S, all-reduce, X backward. The gradients of
the packed weights and of `weights` stay this rank's share, taken with
the global statistics, for `distributed.grad` to sum with the others.
Without a process group nothing of this runs. A call that no backward
will read (no input needs a gradient, or grad mode is off) launches the
forward directly, without the autograd Function. The launch shape
(`node_tile`) and the layout of each kernel's one tensor (`node_scratch`:
the forward's scratch; `node_bwd_scratch`: the backward's outputs and
scratch) are computed here, as the C entry point computes them.
"""

from __future__ import annotations

import array
import functools
import math
from typing import List, NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from lctvqa_torch.ops import _build as K
from lctvqa_torch.ops import conv as C
from lctvqa_torch.ops import cuda_bn
from lctvqa_torch.parallel import distributed

Tensor = torch.Tensor
f32 = torch.float32
EPS = 1e-5

# (name, taps per side, dilation, two stages?) in the order of the packed
# weights: rows 2b and 2b + 1 hold branch b's first and second stage
BRANCHES = (("sep_conv_3x3", 3, 1, True), ("sep_conv_5x5", 5, 1, True),
            ("dil_conv_3x3", 3, 2, False), ("dil_conv_5x5", 5, 2, False))
MAX_TAPS = 25
# columns of `weights` (PRIMITIVES order)
MAX_POOL, AVG_POOL, SKIP, FIRST_BRANCH = 1, 2, 3, 4
SLOTS = 8  # scratch planes of the kernel per (edge, channel)

MIXED_NODE = K.register(K.Kernel(
    "mixed_node_fwd", "lctvqa_mixed_node_fwd", [K.PTR] * 6 + [K.INT] * 6))
MIXED_NODE_BWD = K.register(K.Kernel(
    "mixed_node_bwd", "lctvqa_mixed_node_bwd", [K.PTR] * 10 + [K.INT] * 6))
# the data-parallel mode: one entry point a launch (mixedop.cu)
FWD_SYNC_A = K.register(K.Kernel(
    "mixed_node_fwd_sync_a", "lctvqa_mixed_node_fwd_sync_a",
    [K.PTR] * 4 + [K.INT] * 6))
FWD_SYNC_B = K.register(K.Kernel(
    "mixed_node_fwd_sync_b", "lctvqa_mixed_node_fwd_sync_b",
    [K.PTR] * 5 + [K.LONG] + [K.INT] * 6))
FWD_SYNC_Z = K.register(K.Kernel(
    "mixed_node_fwd_sync_z", "lctvqa_mixed_node_fwd_sync_z",
    [K.PTR] * 6 + [K.LONG] + [K.INT] * 6))
BWD_SYNC_R = K.register(K.Kernel(
    "mixed_node_bwd_sync_r", "lctvqa_mixed_node_bwd_sync_r",
    [K.PTR] * 7 + [K.INT] * 6))
BWD_SYNC_S = K.register(K.Kernel(
    "mixed_node_bwd_sync_s", "lctvqa_mixed_node_bwd_sync_s",
    [K.PTR] * 8 + [K.LONG] + [K.INT] * 6))
BWD_SYNC_X = K.register(K.Kernel(
    "mixed_node_bwd_sync_x", "lctvqa_mixed_node_bwd_sync_x",
    [K.PTR] * 11 + [K.LONG] + [K.INT] * 6))

# what one launch takes (kMaxEdges, kMaxCs of mixedop.cu)
MAX_EDGES = 8
MAX_CS = 64
# NodeEdge of mixedop.cu: x, sn, sh, sw, dw, pw, eight bytes each
EDGE_FIELDS = 6


class NodeWeights(NamedTuple):
    """One edge's conv weights as the kernel takes them, fp32."""

    dw: Tensor  # [8, 25, Cs]: depthwise taps, row-major over the window
    pw: Tensor  # [8, Cs, Cs]: pointwise matrices as [c_in, c_out]


def node_weights(p) -> NodeWeights:
    """Pack one mixed op's params ({primitive: {"dw1", "pw1", ...}}, conv
    weights OIHW). Differentiable: the packed tensors are built from the
    conv leaves by reshape, pad and stack, so a training forward packs
    anew and the leaves get their gradients. A mixed op that holds its
    packed weights under "node" (a served model's, packed once) returns
    them."""
    if "node" in p:
        return p["node"]
    ref = p["dil_conv_3x3"]["pw"]["w"]
    cs = ref.shape[0]
    dws, pws = [], []
    for name, kk, _, two_stage in BRANCHES:
        stages = (("dw1", "pw1"), ("dw2", "pw2")) if two_stage else (
            ("dw", "pw"), None)
        for stage in stages:
            if stage is None:  # rows 5 and 7: a dil conv has one stage
                dws.append(torch.zeros(MAX_TAPS, cs, dtype=f32,
                                       device=ref.device))
                pws.append(torch.zeros(cs, cs, dtype=f32, device=ref.device))
                continue
            taps = p[name][stage[0]]["w"].to(f32).reshape(cs, kk * kk).t()
            dws.append(F.pad(taps, (0, 0, 0, MAX_TAPS - kk * kk)))
            pws.append(p[name][stage[1]]["w"].to(f32)[:, :, 0, 0].t())
    return NodeWeights(torch.stack(dws), torch.stack(pws))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

class _RoundFn(torch.autograd.Function):
    """fp32 -> the nearest value of `dtype`, kept as fp32. Its gradient is
    the identity in fp32, which is how the backward kernel (and the Pallas
    one) treats a stage output's rounding; autograd through a plain
    `.to(dtype)` would round every gradient to `dtype` as well."""

    @staticmethod
    def forward(ctx, x: Tensor, dtype) -> Tensor:
        return x.to(dtype).to(f32)

    @staticmethod
    def backward(ctx, g: Tensor):
        return g, None


def _round(x: Tensor, dtype) -> Tensor:
    return x if dtype == f32 else _RoundFn.apply(x, dtype)


def _stats(o32: Tensor):
    """Mean and 1/sqrt(var + eps) over (N, H, W) of the global batch
    (`cuda_bn.batch_moments`: this tensor's without a process group)."""
    mean, sq = cuda_bn.batch_moments(o32, (0, 1, 2))
    var = sq - mean * mean
    return mean, torch.rsqrt(var + EPS)


def _stage(y32: Tensor, w: NodeWeights, row: int, kk: int, dil: int,
           dtype) -> Tensor:
    """depthwise (fp32 sum) then pointwise (fp32 sum) of y32, whose values
    are of the compute dtype; rounded to that dtype once."""
    cs = y32.shape[-1]
    taps = w.dw[row, :kk * kk].t().reshape(cs, 1, kk, kk)
    t = C.depthwise_conv2d({"w": taps}, y32, padding=(kk - 1) // 2 * dil,
                           dilation=dil)
    return _round(t @ w.pw[row], dtype)


def mixed_node_plain(xs: Sequence[Tensor], nodes: Sequence[NodeWeights],
                     weights: Tensor, cs: int, masks=None) -> Tensor:
    """xs: E tensors [N, H, W, >= cs] of one compute dtype; weights [E, 8]
    fp32 -> [N, H, W, cs] fp32. Every intermediate is an fp32 tensor that
    holds values of the compute dtype. `masks`, where given, holds per edge
    the two sep convs' inner ReLU decisions ([N, H, W, cs] bool, sep3 then
    sep5), which then replace the decisions this version's own forward
    would take (see `mixed_node_bwd_plain`)."""
    weights = weights.to(f32)
    dtype = xs[0].dtype
    xs = [x[..., :cs].to(f32) for x in xs]
    out = None
    for e, x in enumerate(xs):
        term = weights[e, SKIP] * x
        out = term if out is None else out + term
    bias = torch.zeros(cs, dtype=f32, device=out.device)

    def fold(os, op):
        nonlocal out, bias
        term = None
        for e, o32 in enumerate(os):
            mean, rstd = _stats(o32)
            coef = weights[e, op] * rstd
            t = o32 * coef
            term = t if term is None else term + t
            bias = bias + coef * mean
        out = out + term

    for b, (_, kk, dil, two_stage) in enumerate(BRANCHES):
        os = []
        for e, (x, w) in enumerate(zip(xs, nodes)):
            o = _stage(torch.relu(x), w, 2 * b, kk, dil, dtype)
            if two_stage:
                mean, rstd = _stats(o)
                z = (o - mean) * rstd
                y = _round(torch.relu(z) if masks is None
                           else torch.where(masks[e][b], z, 0.0), dtype)
                o = _stage(y, w, 2 * b + 1, kk, 1, dtype)
            os.append(o)
        fold(os, FIRST_BRANCH + b)
    fold([C.max_pool(x, 3, 1, 1) for x in xs], MAX_POOL)
    fold([_round(C.avg_pool(x, 3, 1, 1, count_include_pad=False), dtype)
          for x in xs], AVG_POOL)
    return out - bias


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def node_tile(cs: int) -> int:
    """Edge of the square pixel tile one block of the forward's launches A
    and B takes (lctvqa_mixed_node_fwd_tile): 32 up to 4 channels, 16 up
    to 16, else 8."""
    return 32 if cs <= 4 else (16 if cs <= 16 else 8)


@functools.lru_cache(maxsize=256)
def node_scratch(e: int, n: int, h: int, w: int, cs: int,
                 dtype: torch.dtype) -> dict:
    """The forward's one scratch tensor, in bytes, laid out as the C entry
    point reads it: obuf [8, E, Cs, N*H*W] of the compute dtype (the stage
    outputs), partial [8, E, Cs, 2, blocks] fp32 (per-block sums) followed
    by 2E uint32 counters, stat [8, E, Cs, 2] fp32 (mean, 1/sqrt(var +
    eps)). Every part starts on 16 bytes. -> {"blocks", "obuf", "partial",
    "stat", "total"}: the blocks per edge of launch A and the byte offset
    of each part, and the size."""
    tile = node_tile(cs)
    blocks = n * -(-h // tile) * -(-w // tile)
    size = 2 if dtype == torch.bfloat16 else 4
    obuf = SLOTS * e * cs * n * h * w * size
    partial = SLOTS * e * cs * 2 * blocks * 4 + 2 * e * 4
    at_partial = -(-obuf // 16) * 16
    at_stat = at_partial + -(-partial // 16) * 16
    return {"blocks": blocks, "obuf": 0, "partial": at_partial,
            "stat": at_stat, "total": at_stat + SLOTS * e * cs * 2 * 4}


_ELEM_BYTES = {torch.bfloat16: 2, f32: 4}
BWD_CHUNK = 1024  # pixels per block of the backward's launch R
BWD_SUMS = 7      # sum g, then sum g * o of the six folded ops


@functools.lru_cache(maxsize=256)
def node_bwd_scratch(e: int, n: int, h: int, w: int, cs: int,
                     dtype: torch.dtype) -> dict:
    """The backward's one tensor, in bytes: its outputs dx [E, N, H, W, Cs]
    of the compute dtype, ddw [E, 8, 25, Cs], dpw [E, 8, Cs, Cs] and
    dweights [E, 8] fp32, then the fp32 scratch laid out as mixedop.cu's
    bwd_scratch reads it: launch R's per-chunk sums [E, Cs, 7, chunks], the
    folded BatchNorms' coefficients [6, E, Cs, 3] and gbar [E, Cs], dz
    [2, E, Cs, N*H*W], S's per-block sums [2, E, Cs, 2, blocks] and their
    means [2, E, Cs, 2], the per-block d dw [E, 8, 25, Cs, blocks], d pw
    [E, 8, Cs, Cs, blocks] and d w[skip] [E, blocks], 3E counters. Every
    part starts on 16 bytes. -> {"blocks", "chunks", and the byte offset of
    each part, "total"}: blocks per edge of launches S and X (the forward's
    tile), chunks per edge of launch R."""
    tile = node_tile(cs)
    blocks = n * -(-h // tile) * -(-w // tile)
    m = n * h * w
    chunks = -(-m // BWD_CHUNK)
    lay = {"blocks": blocks, "chunks": chunks}
    at = 0
    for key, nbytes in (
            ("dx", e * m * cs * _ELEM_BYTES[dtype]),
            ("ddw", e * 8 * MAX_TAPS * cs * 4), ("dpw", e * 8 * cs * cs * 4),
            ("dweights", e * 8 * 4), ("scratch", 0),
            ("part_r", e * cs * BWD_SUMS * chunks * 4),
            ("fc", 6 * e * cs * 3 * 4), ("gbar", e * cs * 4),
            ("dzp", 2 * e * cs * m * 4), ("part_s", 2 * e * cs * 2 * blocks * 4),
            ("mstat", 2 * e * cs * 2 * 4),
            ("part_dw", e * 8 * MAX_TAPS * cs * blocks * 4),
            ("part_pw", e * 8 * cs * cs * blocks * 4),
            ("part_skip", e * blocks * 4), ("counters", 3 * e * 4)):
        lay[key] = at
        at += -(-nbytes // 16) * 16
    lay["total"] = at
    return lay


def _edge_args(xs: Sequence[Tensor], nodes: Sequence[NodeWeights]):
    """NodeArgs of mixedop.cu (MAX_EDGES NodeEdge structs of six 8-byte
    fields) for the first len(xs) edges, the rest zero; the caller keeps
    the array alive for the launch and passes its address."""
    vals = []
    for x, nw in zip(xs, nodes):
        sn, sh, sw = x.stride()[:3]
        vals += (x.data_ptr(), sn, sh, sw, nw.dw.data_ptr(),
                 nw.pw.data_ptr())
    vals += [0] * (MAX_EDGES * EDGE_FIELDS - len(vals))
    return array.array("q", vals)


def _node_fwd(xs: Sequence[Tensor], nodes: Sequence[NodeWeights],
              weights: Tensor, cs: int, device):
    """One launch of the forward kernel on at most MAX_EDGES checked edges
    -> (out, scratch, layout)."""
    n, h, w, _ = xs[0].shape
    dtype = xs[0].dtype
    e = len(xs)
    lay = node_scratch(e, n, h, w, cs, dtype)
    scratch = torch.empty(lay["total"], dtype=torch.uint8, device=device)
    out = torch.empty((n, h, w, cs), dtype=f32, device=device)
    base = scratch.data_ptr()
    args = _edge_args(xs, nodes)
    MIXED_NODE.launch(device, args.buffer_info()[0], weights,
                      base + lay["obuf"], base + lay["partial"],
                      base + lay["stat"], out, e, n, h, w, cs,
                      K.DTYPE_CODES[dtype])
    return out, scratch, lay


def node_fwd_launch(xs: List[Tensor], nodes: List[NodeWeights],
                    weights: Tensor, cs: int, device):
    """One launch of the forward kernel on at most MAX_EDGES checked edge
    slices. -> (out, obuf, stat): the result, and the stage outputs
    [8, E, Cs, N*H*W] and their statistics [8, E, Cs, 2] as the backward
    kernel reads them (views of the scratch)."""
    out, scratch, lay = _node_fwd(xs, nodes, weights, cs, device)
    n, h, w, _ = xs[0].shape
    e, dtype = len(xs), xs[0].dtype
    obuf = scratch[:lay["partial"]].view(dtype)[:SLOTS * e * cs * n * h * w]
    stat = scratch[lay["stat"]:].view(f32)
    return (out, obuf.view(SLOTS, e, cs, n * h * w),
            stat.view(SLOTS, e, cs, 2))


def node_bwd_launch(xs: List[Tensor], nodes: List[NodeWeights], weights: Tensor,
                    g: Tensor, obuf: Tensor, stat: Tensor, cs: int, device):
    """One launch of the backward kernel on what `node_fwd_launch` took and
    left; g [N, H, W, Cs] fp32 contiguous. Outputs and scratch are views of
    one tensor (`node_bwd_scratch`), every output element written by the
    kernel. -> (dxs, ddw [E, 8, 25, Cs], dpw [E, 8, Cs, Cs],
    dweights [E, 8])."""
    n, h, w, _ = xs[0].shape
    e, dtype = len(xs), xs[0].dtype
    lay = node_bwd_scratch(e, n, h, w, cs, dtype)
    buf = torch.empty(lay["total"], dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    args = _edge_args(xs, nodes)
    MIXED_NODE_BWD.launch(device, args.buffer_info()[0], base + lay["dx"],
                          weights, g, obuf, stat, base + lay["scratch"],
                          base + lay["ddw"], base + lay["dpw"],
                          base + lay["dweights"], e, n, h, w, cs,
                          K.DTYPE_CODES[dtype])
    return _bwd_outputs(buf, lay, e, n, h, w, cs, dtype)


def _bwd_outputs(buf: Tensor, lay: dict, e: int, n: int, h: int, w: int,
                 cs: int, dtype):
    """The backward's outputs as views of its one tensor -> (dxs, ddw,
    dpw, dweights)."""
    def part(key, dt, shape):
        nbytes = math.prod(shape) * _ELEM_BYTES[dt]
        return buf[lay[key]:lay[key] + nbytes].view(dt).view(shape)

    dx = part("dx", dtype, (e, n, h, w, cs))
    return (list(dx.unbind(0)), part("ddw", f32, (e, 8, MAX_TAPS, cs)),
            part("dpw", f32, (e, 8, cs, cs)), part("dweights", f32, (e, 8)))


class SyncForward:
    """One call of the forward's data-parallel mode on this rank's rows:
    its buffers and its three launches, `a`, `b` and `z`. `sums` is fp32
    [8, E, Cs, 2] (mixedop.cu's stat layout): `a` writes this rank's sums
    of slots 0 and 1, `b` turns those (by then the global batch's) into
    their statistics and writes its sums of slots 2..7, `z` turns those
    into theirs. `ranks` (default: the data group's) sets the global count
    of pixels, equal shares."""

    def __init__(self, xs: List[Tensor], nodes: List[NodeWeights],
                 weights: Tensor, cs: int, device, ranks=None):
        n, h, w, _ = xs[0].shape
        e, dtype = len(xs), xs[0].dtype
        self.dims = (e, n, h, w, cs, K.DTYPE_CODES[dtype])
        self.device, self.weights = device, weights
        self.count = n * h * w * (ranks or distributed.data_world())
        lay = self.lay = node_scratch(e, n, h, w, cs, dtype)
        self.scratch = torch.empty(lay["total"], dtype=torch.uint8,
                                   device=device)
        self.sums = torch.empty((SLOTS, e, cs, 2), dtype=f32, device=device)
        self.out = torch.empty((n, h, w, cs), dtype=f32, device=device)
        self.args = _edge_args(xs, nodes)  # alive for every launch
        base = self.scratch.data_ptr()
        self.obuf_at = base + lay["obuf"]
        self.partial_at = base + lay["partial"]
        self.stat_at = base + lay["stat"]
        self.obuf = self.scratch[:lay["partial"]].view(dtype)[
            :SLOTS * e * cs * n * h * w].view(SLOTS, e, cs, n * h * w)
        self.stat = self.scratch[lay["stat"]:].view(f32).view(SLOTS, e, cs,
                                                              2)

    def a(self) -> None:
        FWD_SYNC_A.launch(self.device, self.args.buffer_info()[0],
                          self.obuf_at, self.partial_at, self.sums,
                          *self.dims)

    def b(self) -> None:
        FWD_SYNC_B.launch(self.device, self.args.buffer_info()[0],
                          self.obuf_at, self.partial_at, self.sums,
                          self.stat_at, self.count, *self.dims)

    def z(self) -> None:
        FWD_SYNC_Z.launch(self.device, self.args.buffer_info()[0],
                          self.weights, self.obuf_at, self.sums,
                          self.stat_at, self.out, self.count, *self.dims)


def node_fwd_sync(xs: List[Tensor], nodes: List[NodeWeights],
                  weights: Tensor, cs: int, device):
    """`node_fwd_launch` in the data-parallel mode: launch A, the inner
    BatchNorms' sums all-reduced over the data group, launch B, the folded
    BatchNorms' sums all-reduced, launch Z. -> (out, obuf, stat) as
    `node_fwd_launch` gives them, the statistics the global batch's."""
    call = SyncForward(xs, nodes, weights, cs, device)
    call.a()
    cuda_bn.global_sums(call.sums[:2])
    call.b()
    cuda_bn.global_sums(call.sums[2:])
    call.z()
    return call.out, call.obuf, call.stat


class SyncBackward:
    """One call of the backward's data-parallel mode on what a
    `SyncForward` left: its buffers and its three launches, `r`, `s` and
    `x`. `r` writes this rank's sums of g and g o ([E, Cs, 7], `sums_r`)
    and d weights of the folded ops, `s` takes the global ones and writes
    its sums of dz and dz xhat ([2, E, Cs, 2], `sums_s`), `x` takes the
    global ones. `outputs()` are `node_bwd_launch`'s."""

    def __init__(self, xs: List[Tensor], nodes: List[NodeWeights],
                 weights: Tensor, g: Tensor, obuf: Tensor, stat: Tensor,
                 cs: int, device, ranks=None):
        n, h, w, _ = xs[0].shape
        e, dtype = len(xs), xs[0].dtype
        self.dims = (e, n, h, w, cs, K.DTYPE_CODES[dtype])
        self.shape = (e, n, h, w, cs, dtype)
        self.device, self.weights, self.g = device, weights, g
        self.obuf, self.stat = obuf, stat
        self.count = n * h * w * (ranks or distributed.data_world())
        lay = self.lay = node_bwd_scratch(e, n, h, w, cs, dtype)
        self.buf = torch.empty(lay["total"], dtype=torch.uint8, device=device)
        self.sums_r = torch.empty((e, cs, BWD_SUMS), dtype=f32, device=device)
        self.sums_s = torch.empty((2, e, cs, 2), dtype=f32, device=device)
        self.args = _edge_args(xs, nodes)
        self.at = {k: self.buf.data_ptr() + lay[k]
                   for k in ("dx", "ddw", "dpw", "dweights", "scratch")}

    def r(self) -> None:
        BWD_SYNC_R.launch(self.device, self.g, self.obuf, self.stat,
                          self.weights, self.at["scratch"], self.sums_r,
                          self.at["dweights"], *self.dims)

    def s(self) -> None:
        BWD_SYNC_S.launch(self.device, self.args.buffer_info()[0], self.g,
                          self.obuf, self.stat, self.weights,
                          self.at["scratch"], self.sums_r, self.sums_s,
                          self.count, *self.dims)

    def x(self) -> None:
        BWD_SYNC_X.launch(self.device, self.args.buffer_info()[0],
                          self.at["dx"], self.weights, self.g, self.obuf,
                          self.stat, self.at["scratch"], self.sums_s,
                          self.at["ddw"], self.at["dpw"],
                          self.at["dweights"], self.count, *self.dims)

    def outputs(self):
        return _bwd_outputs(self.buf, self.lay, *self.shape)


def node_bwd_sync(xs: List[Tensor], nodes: List[NodeWeights], weights: Tensor,
                  g: Tensor, obuf: Tensor, stat: Tensor, cs: int, device):
    """`node_bwd_launch` in the data-parallel mode, on what `node_fwd_sync`
    left: launch R, its sums of g and g o all-reduced, launch S, its sums
    of dz and dz xhat all-reduced, launch X. dx is this rank's rows'; d dw,
    d pw and d weights are this rank's share of the global gradient. ->
    as `node_bwd_launch`."""
    call = SyncBackward(xs, nodes, weights, g, obuf, stat, cs, device)
    call.r()
    cuda_bn.global_sums(call.sums_r)
    call.s()
    cuda_bn.global_sums(call.sums_s)
    call.x()
    return call.outputs()


def sep_inner_inputs_plain(xs: Sequence[Tensor],
                           nodes: Sequence[NodeWeights], cs: int):
    """Per edge, the inputs of the two sep convs' inner ReLU, (o - mean) *
    rstd of the first stage's output o, as `mixed_node_plain` computes
    them: [[sep3, sep5] [N, H, W, cs] fp32 for each edge]."""
    dtype = xs[0].dtype
    out = []
    for x, w in zip(xs, nodes):
        x = torch.relu(x[..., :cs].to(f32))
        zs = []
        for b, (_, kk, dil, _) in enumerate(BRANCHES[:2]):
            o = _stage(x, w, 2 * b, kk, dil, dtype)
            mean, rstd = _stats(o)
            zs.append((o - mean) * rstd)
        out.append(zs)
    return out


def sep_inner_inputs_kept(obuf: Tensor, stat: Tensor, shape):
    """The same from what the forward kernel kept (`node_fwd_launch`'s obuf
    [8, E, Cs, N*H*W] and stat [8, E, Cs, 2]; slots 0 and 1 are the sep
    convs' first stages), computed as the kernel computes them; shape is
    (N, H, W)."""
    o = obuf[:2].to(f32)
    z = (o - stat[:2, :, :, :1]) * stat[:2, :, :, 1:]
    z = z.view(2, o.shape[1], o.shape[2], *shape).permute(1, 0, 3, 4, 5, 2)
    return [list(zs.unbind(0)) for zs in z.unbind(0)]


def mixed_node_bwd_plain(xs: Sequence[Tensor], nodes: Sequence[NodeWeights],
                         weights: Tensor, g: Tensor, cs: int, kept=None):
    """The backward's plain version: autograd through `mixed_node_plain`.
    -> (dxs [N, H, W, cs] in the compute dtype, ddw [E, 8, 25, Cs],
    dpw [E, 8, Cs, Cs], dweights [E, 8]). `kept`, the (obuf, stat) that
    `node_fwd_launch` left, makes the sep convs' inner ReLUs take the
    kernel's decisions: where the inner BatchNorm's output lies within an
    ulp of 0, the kernel's stored forward and this version's recomputed
    one can fall on either side, and the gradient through that element is
    then kept by one and dropped by the other."""
    masks = None if kept is None else [  # the kernel's xhat > 0
        [z > 0 for z in zs]
        for zs in sep_inner_inputs_kept(*kept, xs[0].shape[:3])]
    with torch.enable_grad():
        xs = [x[..., :cs].detach().requires_grad_() for x in xs]
        dws = [nw.dw.detach().requires_grad_() for nw in nodes]
        pws = [nw.pw.detach().requires_grad_() for nw in nodes]
        wts = weights.detach().to(f32).requires_grad_()
        out = mixed_node_plain(xs, [NodeWeights(d, p)
                                    for d, p in zip(dws, pws)], wts, cs,
                               masks)
        e = len(xs)
        grads = torch.autograd.grad(out, [*xs, *dws, *pws, wts], g.to(f32))
    return (list(grads[:e]), torch.stack(grads[e:2 * e]),
            torch.stack(grads[2 * e:3 * e]), grads[3 * e])


class MixedNodeFn(torch.autograd.Function):
    """The forward kernel, then the backward kernel on the stage outputs
    the forward left. Inputs: weights [E, 8] fp32, then the E edge slices
    [N, H, W, cs] (views, channel stride 1), the E packed dw and the E
    packed pw. More edges than one launch takes are split: edges are
    independent given the output's gradient, and under a process group
    each chunk's edges carry their own statistics, summed over the ranks
    (`node_fwd_sync`, `node_bwd_sync`)."""

    @staticmethod
    def forward(ctx, weights: Tensor, cs: int, e: int, *tensors: Tensor):
        xs, dws, pws = tensors[:e], tensors[e:2 * e], tensors[2 * e:]
        device = weights.device
        nodes = [NodeWeights(d, p) for d, p in zip(dws, pws)]
        step = MAX_EDGES
        out, kept = None, []
        fwd = node_fwd_sync if distributed.active() else node_fwd_launch
        for lo in range(0, e, step):
            part, obuf, stat = fwd(
                list(xs[lo:lo + step]), nodes[lo:lo + step],
                weights if e <= step else weights[lo:lo + step].contiguous(),
                cs, device)
            out = part if out is None else out + part
            kept += [obuf, stat]
        ctx.cs, ctx.e, ctx.step = cs, e, step
        ctx.save_for_backward(weights, *tensors, *kept)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g: Tensor):
        cs, e, step = ctx.cs, ctx.e, ctx.step
        weights, *rest = ctx.saved_tensors
        xs, dws, pws = rest[:e], rest[e:2 * e], rest[2 * e:3 * e]
        kept = rest[3 * e:]
        nodes = [NodeWeights(d, p) for d, p in zip(dws, pws)]
        g = g.to(f32).contiguous()
        dxs, ddws, dpws, dwts = [], [], [], []
        bwd = node_bwd_sync if distributed.active() else node_bwd_launch
        for i, lo in enumerate(range(0, e, step)):
            dx, ddw, dpw, dwt = bwd(
                list(xs[lo:lo + step]), nodes[lo:lo + step],
                weights if e <= step else weights[lo:lo + step].contiguous(),
                g, kept[2 * i],
                kept[2 * i + 1], cs, weights.device)
            dxs += dx
            ddws += list(ddw.unbind(0))
            dpws += list(dpw.unbind(0))
            dwts.append(dwt)
        return (torch.cat(dwts), None, None, *dxs, *ddws, *dpws)


def _check_node_call(xs: List[Tensor], nodes: List[NodeWeights],
                     weights: Tensor, cs: int) -> None:
    name = MIXED_NODE.name
    device = weights.device
    if not (device.type == "cuda" and all(x.device == device for x in xs)
            and all(nw.dw.device == device and nw.pw.device == device
                    for nw in nodes)):
        tensors = {f"x{i}": x for i, x in enumerate(xs)}
        tensors.update({f"dw{i}": nw.dw for i, nw in enumerate(nodes)})
        tensors.update({f"pw{i}": nw.pw for i, nw in enumerate(nodes)})
        K.check_cuda_tensors(name, weights=weights, **tensors)
    e = len(xs)
    K.check(e >= 1 and len(nodes) == e, name,
            f"needs as many param sets as edges, got {e} and {len(nodes)}")
    shape, dtype = xs[0].shape, xs[0].dtype
    K.check(all(x.dim() == 4 and x.shape == shape and x.dtype == dtype
                for x in xs), name,
            "edge states must share one [N, H, W, C] shape and dtype")
    K.check(xs[0].numel() > 0 and 1 <= cs <= shape[-1], name,
            f"needs non-empty states with at least cs={cs} channels, got "
            f"{tuple(shape)}")
    K.check(all(x.stride(3) == 1 for x in xs), name,
            "edge states must have channel stride 1")
    K.check(cs <= MAX_CS and shape[0] <= 65535, name,
            f"cs={cs}, N={shape[0]} too large (needs cs <= {MAX_CS}, "
            "N <= 65535)")
    K.check(dtype in K.DTYPE_CODES, name,
            f"compute dtype {dtype} is not supported by the kernel "
            "(float32 or bfloat16)")
    K.check(weights.shape == (e, 8), name,
            f"weights must be [{e}, 8], got {tuple(weights.shape)}")
    dw_shape, pw_shape = (8, MAX_TAPS, cs), (8, cs, cs)
    for nw in nodes:
        K.check(nw.dw.shape == dw_shape and nw.pw.shape == pw_shape
                and nw.dw.dtype == f32 and nw.pw.dtype == f32
                and nw.dw.is_contiguous() and nw.pw.is_contiguous(), name,
                f"packed weights must be contiguous fp32 [8, {MAX_TAPS}, "
                f"{cs}] and [8, {cs}, {cs}]")


def mixed_node(xs: Sequence[Tensor], p_list: Sequence[dict], weights: Tensor,
               cs: int) -> Tensor:
    """One cell node's stride-1 mixed ops, summed over its E edges
    (replaces mixed_node_pallas_hwcn), differentiable once. xs: E edge
    states [N, H, W, C] of one compute dtype (fp32 or bf16), of which
    channels [0, cs) are read in place; p_list: the E edges' mixed-op
    params; weights [E, 8] fp32. -> [N, H, W, cs] fp32."""
    xs = list(xs)
    nodes = [node_weights(p) for p in p_list]
    if xs[0].device.type == "cpu":
        return mixed_node_plain(xs, nodes, weights, cs)
    _check_node_call(xs, nodes, weights, cs)
    if weights.dtype != f32 or not weights.is_contiguous():
        weights = weights.to(f32).contiguous()
    e = len(xs)
    if torch.is_grad_enabled() and (
            weights.requires_grad or any(x.requires_grad for x in xs)
            or any(nw.dw.requires_grad or nw.pw.requires_grad
                   for nw in nodes)):
        return MixedNodeFn.apply(
            weights, cs, e, *[x[..., :cs] for x in xs],
            *[nw.dw for nw in nodes], *[nw.pw for nw in nodes])
    # no backward will read the stage outputs: no Function, no views
    fwd = node_fwd_sync if distributed.active() else _node_fwd
    out = None
    for lo in range(0, e, MAX_EDGES):
        part = fwd(
            xs[lo:lo + MAX_EDGES], nodes[lo:lo + MAX_EDGES],
            weights if e <= MAX_EDGES
            else weights[lo:lo + MAX_EDGES].contiguous(),
            cs, weights.device)[0]
        out = part if out is None else out + part
    return out
