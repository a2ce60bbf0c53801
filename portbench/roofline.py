"""The least time the card could take for one launch of a kernel, at
that launch's shapes: the larger of its bytes (each input read once,
each output written once) over the memory's rate and its operations
over the peak rate for their type. Frozen copies of the bounds the
kernels were built against; NVIDIA H100 SXM data sheet rates (700 W).
"""

from __future__ import annotations

from typing import Tuple

H100 = {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12}
SIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def bound(n_bytes: float, flops: float, dname: str) -> Tuple[float, str]:
    """-> (seconds, "bytes" or "operations")."""
    by_bytes, by_ops = n_bytes / H100["bytes"], flops / H100[dname]
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def node_fwd(n, h, w, cs, edges, dname) -> float:
    """The mixed-op node forward: each edge's Cs-channel slice read once,
    the fp32 output written once; per input element 102 depthwise taps,
    six Cs-wide pointwise sums, two 9-tap pools and the statistics and
    fold of seven stage outputs, all fp32 outside the tensor cores."""
    elems = n * h * w * cs
    flops = edges * elems * (2 * 102 + 2 * 6 * cs + 18 + 7 * 5)
    return bound(edges * elems * SIZE[dname] + elems * 4, flops,
                 "float32")[0]


def node_bwd(n, h, w, cs, edges, dname) -> float:
    """The node backward: each edge's slice and the fp32 output gradient
    read once, each dx written once; three times the forward's
    operations."""
    elems = n * h * w * cs
    flops = 3 * edges * elems * (2 * 102 + 2 * 6 * cs + 18 + 7 * 5)
    return bound(2 * edges * elems * SIZE[dname] + elems * 4, flops,
                 "float32")[0]


def bn_fwd(numel: int, x_dname: str, out_dname: str) -> float:
    """Affine-free batch-statistics BatchNorm forward: x read, y written,
    five operations an element."""
    return bound(numel * (SIZE[x_dname] + SIZE[out_dname]), 5 * numel,
                 "float32")[0]


def bn_bwd(numel: int, x_dname: str, g_dname: str) -> float:
    """Its backward: x and the output gradient read, dx written, ten
    operations an element."""
    return bound(numel * (2 * SIZE[x_dname] + SIZE[g_dname]), 10 * numel,
                 "float32")[0]


def greedy_generate(b, e, h, t, v, dname) -> float:
    """The whole greedy decode: the LSTM's and the head's weights read
    once, one fp32 embedding row gathered a token, the tokens written;
    T steps of the gate products and the head at the operands' rate."""
    wb = SIZE[dname]
    weights = (e + h) * 4 * h * wb + 4 * h * 4
    head = h * v * wb + v * 4
    cell_flops = 2 * b * (e + h) * 4 * h
    return bound(weights + head + b * h * 4 + b * t * e * 4 + b * t * 4,
                 t * (cell_flops + 2 * b * h * v), dname)[0]
