"""Optimizers with their state held explicitly (port of
lctvqa/optim/optimizers.py).

`model_optimizer`: global-norm clip at 5, then Adam(1e-3), the learning
rate set per epoch (StepLR), for the EF and W models. `arch_optimizer`:
Adam(6e-4, betas (0.5, 0.999)) with weight decay 1e-3 added to the
gradient before the moments, for the architecture parameters.

A state is a plain dict `{"step": int, "lr": float, "m": tree, "v": tree}`
whose trees mirror the params, so a checkpoint holds it as it is. The
clip is optax's: the gradients are scaled by clip / max(norm, clip), not
divided by norm + 1e-6 as `torch.nn.utils.clip_grad_norm_` does. Adam is
torch's and optax's: eps 1e-8 outside the root, bias correction on both
moments. A leaf whose gradient is None (the frozen VGG trunk, which is
detached in the forward) counts as a zero gradient: its moments stay 0
and it does not move, exactly as under the JAX package's stop_gradient.
`sgd_step` is the architects' inner unroll, w' = w - lr * g.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Tuple

import torch

from lctvqa_torch.config import TrainConfig


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in a fixed order: dict keys as inserted, lists in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def with_grad(tree: Any) -> Any:
    """The same storage as fresh leaves that require a gradient."""
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def tree_from_leaves(tree: Any, leaves) -> Any:
    """A tree shaped like `tree` whose leaves are `leaves`, in
    `tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam's hyperparameters; `init` and `update` carry the state."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 0.0       # 0: no clipping
    weight_decay: float = 0.0    # added to the gradient before the moments

    def init(self, params) -> dict:
        return {"step": 0, "lr": float(self.learning_rate),
                "m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, params, grads, state) -> Tuple[Any, dict]:
        """-> (new params, new state); the inputs are left as they are.
        `grads` are the leaves' gradients in `tree_leaves` order, None for
        a leaf the loss does not reach."""
        leaves = tree_leaves(params)
        grads = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                 for p, g in zip(leaves, grads)]
        # the whole update in multi-tensor calls: a supernet has about a
        # thousand leaves, and one launch per leaf and operation would
        # leave the card waiting for the host
        if self.grad_clip:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = self.grad_clip / torch.clamp(norm, min=self.grad_clip)
            grads = torch._foreach_mul(grads, scale)
        if self.weight_decay:
            grads = torch._foreach_add(grads, leaves,
                                       alpha=self.weight_decay)
        step = state["step"] + 1
        c1, c2 = 1.0 - self.b1 ** step, 1.0 - self.b2 ** step
        ms = torch._foreach_mul(tree_leaves(state["m"]), self.b1)
        torch._foreach_add_(ms, grads, alpha=1.0 - self.b1)
        vs = torch._foreach_mul(tree_leaves(state["v"]), self.b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(torch._foreach_div(vs, c2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(ms, c1), denom)
        new = torch._foreach_add(leaves, upd, alpha=-state["lr"])
        return (tree_from_leaves(params, new),
                {"step": step, "lr": state["lr"],
                 "m": tree_from_leaves(params, ms),
                 "v": tree_from_leaves(params, vs)})


def model_optimizer(cfg: TrainConfig) -> Optimizer:
    """clip_by_global_norm(grad_clip) -> Adam; the learning rate lives in
    the state and is set once per epoch (`set_learning_rate`)."""
    return Optimizer(cfg.learning_rate, grad_clip=cfg.grad_clip)


def arch_optimizer(cfg: TrainConfig) -> Optimizer:
    """torch.optim.Adam semantics: grad += wd * param before the moments."""
    return Optimizer(cfg.arch_learning_rate, b1=cfg.arch_adam_b1,
                     b2=cfg.arch_adam_b2,
                     weight_decay=cfg.arch_weight_decay)


def step_lr(base_lr: float, epoch: int, step_size: int, gamma: float) -> float:
    """StepLR: lr = base * gamma^(epoch // step_size)."""
    return base_lr * math.pow(gamma, epoch // step_size)


def set_learning_rate(opt_state: dict, lr: float) -> dict:
    opt_state["lr"] = float(lr)
    return opt_state


def sgd_step(params, grads, lr):
    """One plain SGD step w' = w - lr * g over a tree (the architects'
    inner unroll, without momentum or weight decay, both zero in the
    reference). `grads` are the leaves' gradients in `tree_leaves` order;
    a leaf whose gradient is None (the frozen VGG trunk, a leaf the loss
    does not reach) stays as it is. Differentiable: under
    `create_graph` the step carries the gradient's own graph."""
    return tree_from_leaves(params, [p if g is None else p - lr * g
                                     for p, g in zip(tree_leaves(params),
                                                     grads)])
