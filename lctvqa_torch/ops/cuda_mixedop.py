"""The node-batched PC-DARTS mixed op, forward: the kernel and its plain
version.

Counterpart of `lctvqa/ops/pallas_mixedop.py::mixed_node_pallas_hwcn`
(forward; the backward comes with training); the kernel is in
`lctvqa_torch/csrc/mixedop.cu`. For the E stride-1 edges of one cell
node, on the first Cs channels of each edge's NHWC state, both versions
compute

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

The wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. It takes any N >= 1 and any
H, W: the only condition on an edge is stride 1.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import torch

from lctvqa_torch.ops import _build as K
from lctvqa_torch.ops import conv as C

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


class _Edge(ctypes.Structure):  # NodeEdge of mixedop.cu
    _fields_ = [("x", ctypes.c_void_p), ("sn", ctypes.c_longlong),
                ("sh", ctypes.c_longlong), ("sw", ctypes.c_longlong),
                ("dw", ctypes.c_void_p), ("pw", ctypes.c_void_p)]


class NodeWeights(NamedTuple):
    """One edge's conv weights as the kernel takes them, fp32."""

    dw: Tensor  # [8, 25, Cs]: depthwise taps, row-major over the window
    pw: Tensor  # [8, Cs, Cs]: pointwise matrices as [c_in, c_out]


def node_weights(p) -> NodeWeights:
    """Pack one mixed op's params ({primitive: {"dw1", "pw1", ...}}, conv
    weights OIHW) once, outside the forward. A mixed op that holds its
    packed weights under "node" (a served model's) returns them."""
    if "node" in p:
        return p["node"]
    cs = p["dil_conv_3x3"]["pw"]["w"].shape[0]
    ref = p["dil_conv_3x3"]["pw"]["w"]
    dw = torch.zeros(8, MAX_TAPS, cs, dtype=f32, device=ref.device)
    pw = torch.zeros(8, cs, cs, dtype=f32, device=ref.device)
    for b, (name, kk, _, two_stage) in enumerate(BRANCHES):
        stages = (("dw1", "pw1"), ("dw2", "pw2")) if two_stage else (
            ("dw", "pw"),)
        for s, (dw_name, pw_name) in enumerate(stages):
            dw[2 * b + s, :kk * kk] = (p[name][dw_name]["w"].to(f32)
                                       .reshape(cs, kk * kk).t())
            pw[2 * b + s] = p[name][pw_name]["w"].to(f32)[:, :, 0, 0].t()
    return NodeWeights(dw, pw)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _stats(o32: Tensor):
    mean = o32.mean((0, 1, 2))
    var = (o32 * o32).mean((0, 1, 2)) - mean * mean
    return mean, torch.rsqrt(var + EPS)


def _stage(y: Tensor, w: NodeWeights, row: int, kk: int, dil: int) -> Tensor:
    """depthwise (fp32 sum) then pointwise (fp32 sum) of y, whose values
    are of the compute dtype; rounded to that dtype once."""
    cs = y.shape[-1]
    taps = w.dw[row, :kk * kk].t().reshape(cs, 1, kk, kk)
    t = C.depthwise_conv2d({"w": taps}, y.to(f32),
                           padding=(kk - 1) // 2 * dil, dilation=dil)
    return (t @ w.pw[row]).to(y.dtype)


def mixed_node_plain(xs: Sequence[Tensor], nodes: Sequence[NodeWeights],
                     weights: Tensor, cs: int) -> Tensor:
    """xs: E tensors [N, H, W, >= cs] of one compute dtype; weights [E, 8]
    fp32 -> [N, H, W, cs] fp32."""
    weights = weights.to(f32)
    xs = [x[..., :cs] for x in xs]
    out = None
    for e, x in enumerate(xs):
        term = weights[e, SKIP] * x.to(f32)
        out = term if out is None else out + term
    bias = torch.zeros(cs, dtype=f32, device=out.device)

    def fold(os, op):
        nonlocal out, bias
        term = None
        for e, o in enumerate(os):
            o32 = o.to(f32)
            mean, rstd = _stats(o32)
            coef = weights[e, op] * rstd
            t = o32 * coef
            term = t if term is None else term + t
            bias = bias + coef * mean
        out = out + term

    for b, (_, kk, dil, two_stage) in enumerate(BRANCHES):
        os = []
        for x, w in zip(xs, nodes):
            o = _stage(torch.relu(x), w, 2 * b, kk, dil)
            if two_stage:
                mean, rstd = _stats(o.to(f32))
                y = torch.relu((o.to(f32) - mean) * rstd).to(x.dtype)
                o = _stage(y, w, 2 * b + 1, kk, 1)
            os.append(o)
        fold(os, FIRST_BRANCH + b)
    fold([C.max_pool(x, 3, 1, 1).to(x.dtype) for x in xs], MAX_POOL)
    fold([C.avg_pool(x, 3, 1, 1, count_include_pad=False).to(x.dtype)
          for x in xs], AVG_POOL)
    return out - bias


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _launch(xs: List[Tensor], nodes: List[NodeWeights], weights: Tensor,
            cs: int, device) -> Tensor:
    name = MIXED_NODE.name
    n, h, w, _ = xs[0].shape
    e, m = len(xs), n * h * w
    dtype = xs[0].dtype
    tile = K.library().lctvqa_mixed_node_tile(cs)
    blocks = n * -(-h // tile) * -(-w // tile)
    obuf = torch.empty(SLOTS, e, cs, m, dtype=dtype, device=device)
    partial = torch.empty(SLOTS, e, cs, 2, blocks, dtype=f32, device=device)
    stat = torch.empty(SLOTS, e, cs, 2, dtype=f32, device=device)
    out = torch.empty(n, h, w, cs, dtype=f32, device=device)
    edges = (_Edge * K.library().lctvqa_mixed_node_max_edges())()
    for slot, x, nw in zip(edges, xs, nodes):
        slot.x, slot.dw, slot.pw = x.data_ptr(), nw.dw.data_ptr(), \
            nw.pw.data_ptr()
        slot.sn, slot.sh, slot.sw = x.stride(0), x.stride(1), x.stride(2)
    MIXED_NODE.launch(device, ctypes.byref(edges), weights, obuf, partial,
                      stat, out, e, n, h, w, cs, K.dtype_code(name, dtype))
    return out


def mixed_node(xs: Sequence[Tensor], p_list: Sequence[dict], weights: Tensor,
               cs: int) -> Tensor:
    """One cell node's stride-1 mixed ops, summed over its E edges
    (replaces mixed_node_pallas_hwcn). xs: E edge states [N, H, W, C] of
    one compute dtype (fp32 or bf16), of which channels [0, cs) are read
    in place; p_list: the E edges' mixed-op params; weights [E, 8] fp32.
    -> [N, H, W, cs] fp32."""
    xs = list(xs)
    nodes = [node_weights(p) for p in p_list]
    if xs[0].device.type == "cpu":
        return mixed_node_plain(xs, nodes, weights, cs)
    name = MIXED_NODE.name
    tensors = {f"x{i}": x for i, x in enumerate(xs)}
    tensors.update({f"dw{i}": nw.dw for i, nw in enumerate(nodes)})
    tensors.update({f"pw{i}": nw.pw for i, nw in enumerate(nodes)})
    device = K.check_cuda_tensors(name, weights=weights, **tensors)
    e = len(xs)
    K.check(e >= 1 and len(nodes) == e, name,
            f"needs as many param sets as edges, got {e} and {len(nodes)}")
    K.check(all(x.dim() == 4 and x.shape == xs[0].shape
                and x.dtype == xs[0].dtype for x in xs), name,
            "edge states must share one [N, H, W, C] shape and dtype")
    K.check(xs[0].numel() > 0 and 1 <= cs <= xs[0].shape[-1], name,
            f"needs non-empty states with at least cs={cs} channels, got "
            f"{tuple(xs[0].shape)}")
    K.check(all(x.stride(3) == 1 for x in xs), name,
            "edge states must have channel stride 1")
    lib = K.library()
    K.check(cs <= lib.lctvqa_mixed_node_max_cs() and xs[0].shape[0] <= 65535,
            name, f"cs={cs}, N={xs[0].shape[0]} too large (needs cs <= "
            f"{lib.lctvqa_mixed_node_max_cs()}, N <= 65535)")
    K.check(weights.shape == (e, 8), name,
            f"weights must be [{e}, 8], got {tuple(weights.shape)}")
    for nw in nodes:
        K.check(nw.dw.shape == (8, MAX_TAPS, cs) and nw.pw.shape == (8, cs, cs)
                and nw.dw.dtype == f32 and nw.pw.dtype == f32
                and nw.dw.is_contiguous() and nw.pw.is_contiguous(), name,
                f"packed weights must be contiguous fp32 [8, {MAX_TAPS}, "
                f"{cs}] and [8, {cs}, {cs}]")
    weights = weights.to(f32).contiguous()
    # edges are independent given the output, so a node with more edges
    # than one launch takes is the sum of several
    step = lib.lctvqa_mixed_node_max_edges()
    out = None
    for lo in range(0, e, step):
        part = _launch(xs[lo:lo + step], nodes[lo:lo + step],
                       weights[lo:lo + step].contiguous(), cs, device)
        out = part if out is None else out + part
    return out
