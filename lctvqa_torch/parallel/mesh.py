"""The data-parallel mesh (counterpart of lctvqa/parallel/mesh.py).

On the JAX package's mesh the batch is sharded over a `data` axis and
the parameters are replicated; XLA inserts the all-reduces. Here the
mesh is the process group of `parallel/distributed.py`: rank r holds the
parameters whole and takes rows [r B/W, (r + 1) B/W) of each global
batch of B rows (`shard_batch`; the loaders take the same rows,
`data/pipeline.py::epoch_batches`), and the steps sum their gradients,
counters and BatchNorm statistics over the ranks, so that every rank
ends each step with the parameters one process would have on the whole
batch. Every kernel flag runs on it: the BatchNorm kernel and the
mixed-op node kernels take the global batch's statistics in their
data-parallel modes (`ops/cuda_bn.py`, `ops/cuda_mixedop.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lctvqa_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the data axis: `size` ranks, this one `rank`."""

    rank: int = 0
    size: int = 1


def make_mesh(num_devices: int = 0, multihost: bool = False) -> Mesh:
    """The data axis over the process group: every rank of it. A
    `num_devices` other than 0 must be the group's size unless the group
    spans hosts (`multihost`, where every process's devices join)."""
    size = distributed.data_world()
    if num_devices and not multihost and num_devices != size:
        raise ValueError(
            f"the mesh asks for {num_devices} devices and the process group "
            f"has {size} rank(s): start one process a GPU (python -m "
            "lctvqa_torch.main --num_devices N, or torchrun)")
    return Mesh(distributed.data_rank(), size)


def from_config(mesh_cfg) -> Mesh:
    """`make_mesh` of a `MeshConfig`."""
    return make_mesh(mesh_cfg.num_devices, mesh_cfg.multihost)


def shard_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of n rows; W must divide n."""
    if n % mesh.size:
        raise ValueError(f"a global batch of {n} rows does not split evenly "
                         f"over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every entry of a global batch (arrays, tensors
    and lists with the batch first)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor, list)):
            out[k] = v[shard_rows(len(v), mesh)]
        else:
            out[k] = v
    return out
