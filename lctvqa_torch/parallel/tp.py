"""Tensor parallelism for the VGG classifier (counterpart of
lctvqa/parallel/tp.py).

The ranks form a (data x model) grid, rank = d * mp + m: a model group
is the mp ranks of one d, which take the same rows of the global batch;
a data group is the dp ranks of one m, over which the batch is split and
the BatchNorm statistics are summed (`distributed.set_data_group`). The
two linears that carry most of the model's linear FLOPs, the VGG
classifier's fc6 (25088 x 4096) and fc7 (4096 x 4096), are split over
the model group as the JAX package annotates them: fc6 by columns (its
output features, bias and int8 scales with them), fc7 by rows (its input
features; bias and scales whole, added once after the sum). fc6's output
and the ReLU and dropout over it stay split; fc7 contracts over the
split and is summed with one all-reduce over the model group, as XLA
places one psum after it. Everything else is replicated.

The int8 leaves (`w_q`, `w_s`, `b`, quant.py) split as the fp ones
(`w`, `b`). fc7's input is quantized per sample against the abs-max of
the whole row, which lies on several ranks: its abs-max is all-reduced
(max) over the model group first, and the int32 products are summed
before the dequantization, so an int8 fc7 gives the bits of one rank's.
Eval only: no gradient crosses the split.

The split stays in this module: `shard_params` gives a tree of tensors
only, and `row_parallel(params, mesh)` installs, while it is open, a
`linear` that runs fc7's shares in that tree through
`row_parallel_linear` and every other linear as it is.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from lctvqa_torch.ops import conv as C
from lctvqa_torch.ops import int8
from lctvqa_torch.ops import nn as N
from lctvqa_torch.parallel import distributed


class ModelGroup:
    """The collectives of a row-parallel linear over one model group."""

    def __init__(self, group, size: int):
        self.group = group
        self.size = size

    def sum(self, y: torch.Tensor) -> torch.Tensor:
        """The partial products of every rank, summed."""
        y = y.contiguous().clone()
        dist.all_reduce(y, group=self.group)
        return y

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the ranks (int8 abs-max scales)."""
        t = t.contiguous().clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t


@dataclasses.dataclass
class Mesh2D:
    """This rank's place on the (data x model) grid."""

    dp: int
    mp: int
    data_index: int
    model_index: int
    model: ModelGroup


def make_mesh_2d(dp: int = 0, mp: int = 1) -> Mesh2D:
    """The (dp x mp) grid over the process group (dp = 0: world / mp),
    every rank on it; its data group becomes the one the data-parallel
    sums run over. Every rank makes every group, in one order, as
    torch.distributed.new_group needs."""
    world = distributed.world()
    dp = dp or world // mp
    if dp * mp != world:
        raise ValueError(f"a {dp} x {mp} (data x model) grid needs "
                         f"{dp * mp} ranks; the process group has {world}")
    d, m = divmod(distributed.rank(), mp)
    model_groups = [dist.new_group([i * mp + j for j in range(mp)])
                    for i in range(dp)]
    data_groups = [dist.new_group([i * mp + j for i in range(dp)])
                   for j in range(mp)]
    distributed.set_data_group(data_groups[m], dp, d)
    return Mesh2D(dp, mp, d, m, ModelGroup(model_groups[d], mp))


# per-leaf split of a TP linear's params: the axis cut over the model
# group, or None for a leaf held whole (added once after the sum)
_COL = {"w": 1, "b": 0, "w_q": 1, "w_s": 0}
_ROW = {"w": 0, "b": None, "w_q": 0, "w_s": None}
# param-dict key -> rule; fc6 and fc7 are in the VGG subtree only
TP_RULES = {"fc6": _COL, "fc7": _ROW}


def _part(t: torch.Tensor, axis, mesh: Mesh2D) -> torch.Tensor:
    if axis is None:
        return t
    n = t.shape[axis]
    if n % mesh.mp:
        raise ValueError(f"a dimension of {n} does not split over "
                         f"{mesh.mp} model ranks")
    k = n // mesh.mp
    return t.narrow(axis, mesh.model_index * k, k).contiguous()


def shard_params(params, mesh: Mesh2D):
    """This rank's share of a param tree: fc6 and fc7 split by
    `TP_RULES`, the rest as it is."""
    if isinstance(params, dict):
        return {k: ({lk: _part(lv, TP_RULES[k].get(lk), mesh)
                     for lk, lv in v.items()}
                    if k in TP_RULES and isinstance(v, dict)
                    else shard_params(v, mesh))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)) and not hasattr(params, "_fields"):
        return type(params)(shard_params(v, mesh) for v in params)
    return params


def _row_shares(tree) -> list:
    """The row-parallel linears' param dicts in a tree of shares."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            if TP_RULES.get(k) is _ROW and isinstance(v, dict):
                out.append(v)
            else:
                out += _row_shares(v)
        return out
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _row_shares(v)]
    return []


def row_parallel_linear(params, x: torch.Tensor, group: ModelGroup,
                        dtype=None) -> torch.Tensor:
    """A row-parallel share of a linear on x [B, K / mp] (fc7's input, a
    share of its columns): this rank's partial product over
    its rows of the weight, summed over the model group, then the bias,
    held whole, added once. int8: x quantized per sample against the
    abs-max of the whole row (the group's max, carried in as one more
    column, whose code is dropped), its int32 products summed before the
    dequantization."""
    if "w_q" in params:
        x = x.to(torch.float32)
        amax = group.max(x.abs().amax(dim=-1, keepdim=True))
        xq, sx = C.quantize_act(torch.cat([x, amax], -1), per_sample=True)
        xq = xq[..., :-1].contiguous()
        w_q = params["w_q"]
        y = int8.int8_matmul(xq.reshape(-1, xq.shape[-1]), w_q)
        y = group.sum(y.reshape(*x.shape[:-1], w_q.shape[1]))  # int32: exact
        return y.to(torch.float32) * (sx * params["w_s"]) + params["b"]
    partial = N.linear({**params, "b": torch.zeros_like(params["b"])}, x,
                       dtype=dtype)
    return group.sum(partial) + params["b"].to(torch.float32)


@contextlib.contextmanager
def row_parallel(params, mesh: Mesh2D):
    """While open, `ops/nn.py::linear` on a row-parallel share in
    `params` (a tree from `shard_params`) runs `row_parallel_linear` over
    the model group; every other call runs as it is."""
    shares = {id(p) for p in _row_shares(params)}
    plain = N.linear

    def linear(p, x, dtype=None):
        if id(p) in shares:
            return row_parallel_linear(p, x, mesh.model, dtype)
        return plain(p, x, dtype=dtype)

    N.linear = linear
    try:
        yield
    finally:
        N.linear = plain
