"""Process groups and the collectives of data parallelism (counterpart of
lctvqa/parallel/distributed.py, and of the all-reduces XLA inserts on the
JAX package's mesh).

One process a GPU. `initialize` makes the process group: NCCL between
CUDA devices, gloo on the CPU (the tests); with no arguments it reads
torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), as
`jax.distributed.initialize` finds a pod's. Every rank holds the same
parameters and takes its own rows of the global batch; the losses are
means over equal shards, so the global loss is the mean of the ranks'.

The data group is the set of ranks whose rows make up one global batch:
every rank, unless `parallel/tp.py` splits the ranks into model groups,
where the ranks of one model group share their rows. Gradients,
counters and the BatchNorm statistics are summed over it. Every
collective here is an `all_reduce`, which gloo also takes on CUDA
tensors.

The data-parallel path runs wherever a process group exists (`active`),
with one rank too: its sums over one rank are the identity, which lets
one card run the NCCL route. Without a process group each helper
returns its input as it is, so a single process runs the code and the
bits it ran before data parallelism existed.
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# (group, its size, this rank's index in it); None: the whole world
_DATA_GROUP: Optional[tuple] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               backend: Optional[str] = None) -> None:
    """torch.distributed.init_process_group for this process: NCCL where
    `device` is CUDA, gloo on the CPU (`backend` overrides: gloo also
    carries CUDA tensors, which runs several ranks on one card). The
    coordinator is "host:port" of rank 0; without one, torchrun's
    environment gives rank, world size and address."""
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    if backend == "nccl":
        torch.cuda.set_device(local_device(device))


def shutdown() -> None:
    global _DATA_GROUP
    _DATA_GROUP = None
    if dist.is_initialized():
        dist.destroy_process_group()


def active() -> bool:
    """A process group exists: the data-parallel path is taken."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def launched() -> bool:
    """A launcher such as torchrun started this process as one rank (its
    environment names the rank and the world)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def free_port() -> int:
    """A port on localhost that no socket holds now, for rank 0's store."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def ranks_on_host(num_devices: int, device, cpu: int = 1) -> int:
    """Ranks a command starts on this host: `num_devices`, or for 0 one a
    card on a CUDA device and `cpu` on the CPU."""
    if num_devices:
        return num_devices
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    return cpu


def run_as_ranks(fn, argv, device, n: int, join: Optional[tuple] = None):
    """Run `fn(argv)` as a command's ranks, the one policy of the training
    and eval CLIs: inside a process group that exists, as it is; as one
    rank of a group started from outside, after joining it (`join`: the
    coordinator's address, the ranks in all, this one's, each None for
    torchrun's environment; or torchrun's environment alone); in n
    spawned ranks on this host for n > 1, each joining the group first
    (-> None: the results stay in the ranks); else as the only process.
    `fn` is a module-level function, which spawn pickles by name."""
    if active():
        return fn(argv)
    if join is not None or launched():
        return _as_rank(fn, argv, device, *(join or (None, None, None)))
    if n > 1:
        import torch.multiprocessing as mp

        mp.start_processes(_spawned_rank,
                           args=(fn, argv, device, n, free_port()),
                           nprocs=n, start_method="spawn")
        return None
    return fn(argv)


def _as_rank(fn, argv, device, address, processes, process_id):
    initialize(address, processes, process_id, device=device)
    try:
        return fn(argv)
    finally:
        shutdown()


def _spawned_rank(rank: int, fn, argv, device, world: int, port: int):
    _as_rank(fn, argv, device, f"localhost:{port}", world, rank)


def local_rank() -> int:
    """This rank's index on its host: torchrun's LOCAL_RANK, else the rank
    modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return rank() % cards if cards else rank()


def local_device(device="cuda") -> torch.device:
    """The device this rank runs on: `device` as given for the CPU or a
    card named by index, else cuda:<local rank> once there are several
    ranks (one card a rank). A CUDA device without a card raises."""
    d = torch.device(device)
    if d.type != "cuda":
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(
            "this runs on a CUDA device and none is available; pass "
            "device='cpu' (--device cpu) to run on the CPU")
    if d.index is not None or world() == 1:
        return d
    index = local_rank()
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"rank {rank()} takes cuda:{index}, and this host "
                           f"has {torch.cuda.device_count()} card(s)")
    return torch.device("cuda", index)


def rank_seed(seed: int) -> int:
    """The seed of this rank's dropout or sampling stream: `seed` itself
    on rank 0 (one process draws what it drew before), another stream on
    every other rank."""
    return seed + 1_000_003 * rank()


def process_index_range(total: int) -> range:
    """This rank's contiguous share of `total` indices; the last rank
    takes the remainder."""
    per = total // world()
    start = rank() * per
    return range(start, total if rank() == world() - 1 else start + per)


# ---------------------------------------------------------------------------
# the data group
# ---------------------------------------------------------------------------

def set_data_group(group, size: int = 1, index: int = 0) -> None:
    """Sum over `group` (size ranks, this one the index-th) from now on;
    None: the whole world again."""
    global _DATA_GROUP
    _DATA_GROUP = None if group is None else (group, size, index)


def data_group():
    return None if _DATA_GROUP is None else _DATA_GROUP[0]


def data_world() -> int:
    """Ranks whose rows make up one global batch."""
    return world() if _DATA_GROUP is None else _DATA_GROUP[1]


def data_rank() -> int:
    """This rank's index among them: which rows of a global batch it takes."""
    return rank() if _DATA_GROUP is None else _DATA_GROUP[2]


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """The sum of x over a group's ranks. Its derivative is the same sum of
    the incoming gradient: every rank's loss reaches every rank's x
    through the sum. The backward calls the Function again, so a gradient
    taken with create_graph can be differentiated through it once more."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of x over the data group (over `group` where
    given); x itself without a process group."""
    if not active():
        return x
    return _AllReduceSum.apply(x, data_group() if group is None else group)


def reduce_grads(grads: Sequence[Optional[torch.Tensor]]
                 ) -> List[Optional[torch.Tensor]]:
    """The gradients of every rank's share of the loss summed over the
    data group, in one collective (None stays None: a leaf the loss does
    not reach on one rank it reaches on none). Differentiable, for the
    architects' gradients taken with create_graph."""
    grads = list(grads)
    if not active():
        return grads
    present = [g for g in grads if g is not None]
    if not present:
        return grads
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in present]))
    it = iter(torch.split(flat, [g.numel() for g in present]))
    return [None if g is None else next(it).view_as(g) for g in grads]


def grad(loss: torch.Tensor, leaves, create_graph: bool = False
         ) -> List[Optional[torch.Tensor]]:
    """d (global loss) / d leaf for each leaf, None where the loss does not
    reach it: the global loss is the mean of the ranks' `loss`, each a
    mean over an equal share of the global batch, so each rank
    differentiates loss / W and the results are summed."""
    w = data_world()
    out = torch.autograd.grad(loss / w if active() else loss, list(leaves),
                              create_graph=create_graph, allow_unused=True)
    return reduce_grads(out)


def reduce_stats(means: Sequence[torch.Tensor] = (),
                 sums: Sequence[torch.Tensor] = ()) -> tuple:
    """0-d tensors as the global batch sees them, in one collective: each
    of `means` (a mean over this rank's rows) averaged over the data
    group, each of `sums` (a count) summed, each in its own dtype."""
    if not active():
        return (*means, *sums)
    w = data_world()
    vals = list(means) + list(sums)
    buf = torch.stack([v.detach().to(torch.float64).reshape(())
                       for v in vals])
    buf[:len(means)] /= w
    dist.all_reduce(buf, group=data_group())
    return tuple(b.to(v.dtype) for b, v in zip(buf, vals))


def all_reduce_host(values: Sequence[float], device) -> List[float]:
    """Host numbers summed over the data group (a tensor on `device`
    carries them: NCCL takes only CUDA tensors)."""
    if not active():
        return [float(v) for v in values]
    buf = torch.tensor([float(v) for v in values], dtype=torch.float64,
                       device=device)
    dist.all_reduce(buf, group=data_group())
    return buf.tolist()
