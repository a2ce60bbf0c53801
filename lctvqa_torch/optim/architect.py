"""Plain DARTS second-order architect (port of lctvqa/optim/architect.py).

The bilevel gradient of the architecture parameters through one unrolled
SGD step of the weights,

    d/d_alpha  L_val( w - eta * grad_w L_train(w, alpha),  alpha )

'exact' takes it with autograd straight through the unroll: the inner
gradient is taken with `create_graph=True`, so the outer gradient holds
both the direct alpha term and the implicit
-eta * (d^2 L_train / d_alpha d_w) @ grad_w' L_val term. 'fd' replays the
reference's central finite difference (R = r / ||v||) for that implicit
term, both probes on the same dropout draws (common random numbers).

Both modes run under `ops.conv.second_order` (BatchNorm and fp32
convolutions on twice-differentiable routes); `loss_fn` takes the plain
versions of the kernels itself, as `architect_lct.plain_model_config`
gives them.

Under data parallelism every gradient of the unroll is the global
batch's (`grads`), and `torch.utils.checkpoint` recomputes forwards that
sum BatchNorm statistics over the ranks: every rank runs the same graph,
so every rank reaches each collective in the same order.

Randomness: where the JAX package splits one key, the port draws one seed
per use from the caller's generator (`draw_seeds`) and gives each use a
fresh `torch.Generator` seeded with it (`seeded`), so a probe, or a
forward that a checkpoint recomputes, draws the same masks again.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from lctvqa_torch.ops import conv as C
from lctvqa_torch.optim.optimizers import (sgd_step, tree_from_leaves,
                                           tree_leaves, with_grad)
from lctvqa_torch.parallel import distributed


def draw_seeds(gen: torch.Generator, n: int) -> List[int]:
    """n seeds from `gen`, on its device (one read back to the host)."""
    return torch.randint(0, 2 ** 62, (n,), generator=gen,
                         device=gen.device).tolist()


def seeded(seed: int, device) -> torch.Generator:
    """A fresh generator on `device` seeded with `seed`."""
    return torch.Generator(device=device).manual_seed(seed)


def grads(loss: torch.Tensor, tree, create_graph: bool = False
          ) -> List[Optional[torch.Tensor]]:
    """d loss / d leaf for every leaf of `tree` in `tree_leaves` order;
    None where the loss does not reach the leaf. Under data parallelism
    the loss is the global batch's and the gradient summed over the ranks
    (`distributed.grad`), differentiably where `create_graph` asks for a
    gradient of it, so every inner step of an unroll is the global one."""
    return distributed.grad(loss, tree_leaves(tree),
                            create_graph=create_graph)


def global_loss(loss: torch.Tensor) -> torch.Tensor:
    """The detached loss of the global batch: the mean of the ranks'."""
    return distributed.reduce_stats((loss.detach(),))[0]


def zero_filled(tree, gs) -> list:
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(tree_leaves(tree), gs)]


def global_norm(leaves) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def perturb(tree, vec, scale) -> object:
    """tree + scale * vec, leaf by leaf (vec in `tree_leaves` order)."""
    return tree_from_leaves(tree, [p.detach() + scale * v for p, v in
                                   zip(tree_leaves(tree), vec)])


def central_difference(plus, minus, r) -> list:
    return [(a - b) / (2 * r) for a, b in zip(plus, minus)]


def make_darts_arch_grad(loss_fn: Callable, mode: str = "exact",
                         r: float = 1e-2):
    """loss_fn(params, arch, batch, gen) -> scalar; `gen` is the dropout
    generator of that call.

    Returns arch_grad(params, arch, train_batch, val_batch, eta, gen)
    -> (gradient shaped like arch, val_loss as a 0-d tensor); `gen`
    gives the call's seeds."""

    def exact(params, arch, train_batch, val_batch, eta, gen):
        s_train, s_val = draw_seeds(gen, 2)
        dev = gen.device
        with torch.enable_grad(), C.second_order():
            a, p = with_grad(arch), with_grad(params)
            g_w = grads(loss_fn(p, a, train_batch, seeded(s_train, dev)), p,
                        create_graph=True)
            unrolled = sgd_step(p, g_w, eta)
            val_loss = loss_fn(unrolled, a, val_batch, seeded(s_val, dev))
            g_a = zero_filled(a, grads(val_loss, a))
        return tree_from_leaves(arch, g_a), global_loss(val_loss)

    def fd(params, arch, train_batch, val_batch, eta, gen):
        s_train, s_val, s_probe = draw_seeds(gen, 3)
        dev = gen.device
        with torch.enable_grad(), C.second_order():
            # unroll: w' = w - eta * grad_w L_train
            p = with_grad(params)
            g_w = grads(loss_fn(p, arch, train_batch, seeded(s_train, dev)), p)
            unrolled = with_grad(sgd_step(params, g_w, eta))
            a = with_grad(arch)
            # dalpha = grad_alpha L_val(w'), vector = grad_w' L_val(w')
            val_loss = loss_fn(unrolled, a, val_batch, seeded(s_val, dev))
            both = grads(val_loss, [unrolled, a])
            n_w = len(tree_leaves(unrolled))
            vector = zero_filled(unrolled, both[:n_w])
            dalpha = zero_filled(a, both[n_w:])
            # the implicit term by a central difference
            big_r = r / global_norm(vector)
            probes = [zero_filled(a, grads(loss_fn(
                perturb(params, vector, sign * big_r), a, train_batch,
                seeded(s_probe, dev)), a)) for sign in (1.0, -1.0)]
        implicit = central_difference(*probes, big_r)
        g_a = [d - eta * i for d, i in zip(dalpha, implicit)]
        return tree_from_leaves(arch, g_a), global_loss(val_loss)

    return exact if mode == "exact" else fd
