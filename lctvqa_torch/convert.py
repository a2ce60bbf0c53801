"""Parameter layouts: the JAX package's pytree (numpy) <-> the port's.

The port keeps the JAX package's tree structure (dicts, lists, tuples)
and its layouts with one exception:

- conv weights, the only 4-D leaves: HWIO (JAX) <-> OIHW (torch). The one
  rule covers every conv of the search tree and of a derived network's
  (whose BatchNorm scales and biases are 1-D and stay): a depthwise [k,
  k, 1, C] becomes [C, 1, k, k], a 1x7 [1, 7, ci, co] (AmoebaNet's
  conv_7x1_1x7) becomes [co, ci, 1, 7], a 7x1 likewise;
- arch parameters (alphas [edges, 8], betas [edges]) stay as they are;
- linear weights stay [in, out] in both, so the port computes x @ w;
- LSTM w_ih [in, 4H] and w_hh [H, 4H] stay as they are, with b_ih and
  b_hh kept separate;
- embedding tables stay as they are.

Both directions copy values exactly, so a round trip is exact.

Optimizer states and checkpoints: the port's Adam state is the plain dict
`{"step", "lr", "m", "v"}`; the JAX package's is optax's nest of
namedtuples. `opt_state_from_jax` reads the latter (live, or as the
`NamedTupleNode`s the port's checkpoint loader makes of it);
`opt_state_to_jax` fills a template state made by the JAX package's own
optimizer, so this module needs no optax. Lists of BatchNorm running
statistics are trees of 1-D leaves and go through `from_jax`/`to_jax` as
they are. `checkpoint_from_jax`/`checkpoint_to_jax` map a whole
checkpoint tree; `checkpoint_trees` reads a checkpoint of either package
as the port's, `checkpoint_params` only its param trees.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch


def _map(tree, leaf_fn):
    if isinstance(tree, dict):
        return {k: _map(v, leaf_fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, leaf_fn) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_map(v, leaf_fn) for v in tree)
    return leaf_fn(tree)


def from_jax(tree: Any, device: Union[str, torch.device] = "cpu") -> Any:
    """JAX-layout pytree of arrays -> tree of torch tensors on `device`."""
    def leaf(a):
        a = np.asarray(a)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        return torch.from_numpy(np.array(a, order="C")).to(device)

    return _map(tree, leaf)


def to_jax(tree: Any) -> Any:
    """Tree of torch tensors -> JAX-layout pytree of numpy arrays."""
    def leaf(t):
        a = t.detach().cpu().numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        return np.ascontiguousarray(a)

    return _map(tree, leaf)


# ---------------------------------------------------------------------------
# optimizer states and checkpoints
# ---------------------------------------------------------------------------

def _fields(node, *names):
    """Values of a namedtuple by field name: a live one has attributes, a
    checkpoint's NamedTupleNode has them in the class's field order."""
    if hasattr(node, "values") and hasattr(node, "name"):
        order = {"InjectStatefulHyperparamsState":
                 ("count", "hyperparams", "hyperparams_states",
                  "inner_state"),
                 "ScaleByAdamState": ("count", "mu", "nu")}[node.name]
        return tuple(node.values[order.index(n)] for n in names)
    return tuple(getattr(node, n) for n in names)


def _is_adam(node) -> bool:
    name = getattr(node, "name", None) if hasattr(node, "values") else None
    return (name or type(node).__name__) == "ScaleByAdamState"


def opt_state_from_jax(state, device: Union[str, torch.device] = "cpu",
                       lr: float = 0.0) -> dict:
    """An optax state of the JAX package's `model_optimizer` (injected
    hyperparameters around clip + Adam) or `arch_optimizer` (a chain with
    one Adam state, whose learning rate is not in the state: pass `lr`)
    -> the port's {"step", "lr", "m", "v"}."""
    if isinstance(state, tuple) and not hasattr(state, "_fields") \
            and not hasattr(state, "name"):
        (adam,) = [s for s in state if _is_adam(s)]
    else:
        hyper, inner = _fields(state, "hyperparams", "inner_state")
        lr = float(np.asarray(hyper["learning_rate"]))
        (adam,) = [s for s in inner[1] if _is_adam(s)]
    count, mu, nu = _fields(adam, "count", "mu", "nu")
    return {"step": int(np.asarray(count)), "lr": float(lr),
            "m": from_jax(mu, device), "v": from_jax(nu, device)}


def opt_state_to_jax(state: dict, template):
    """The port's optimizer state -> the optax state `template` (what the
    JAX package's optimizer `.init` returned for the same params) with
    this state's step, learning rate and moments."""
    count = np.asarray(state["step"], np.int32)
    mu, nu = to_jax(state["m"]), to_jax(state["v"])

    def fill(adam):
        return adam._replace(count=count, mu=mu, nu=nu)

    if not hasattr(template, "_fields"):  # arch_optimizer: a plain chain
        return tuple(fill(s) if _is_adam(s) else s for s in template)
    clip, chain = template.inner_state
    hyper = dict(template.hyperparams,
                 learning_rate=np.asarray(state["lr"], np.float32))
    return template._replace(
        count=count, hyperparams=hyper,
        inner_state=(clip, tuple(fill(s) if _is_adam(s) else s
                                 for s in chain)))


# the LCT loop's checkpoints, and the DARTS family's ("params", "opt")
_PARAM_KEYS = ("ef_params", "w_params", "params", "arch", "bn_running")
_OPT_KEYS = ("ef_opt", "w_opt", "opt", "arch_opt")


def is_jax_checkpoint(state: dict) -> bool:
    """Whether a loaded checkpoint tree is the JAX package's: one of its
    optimizer states is optax's nest of namedtuples, not the port's
    {"step", "lr", "m", "v"}. (A file that holds no optimizer state reads
    as the port's.)"""
    return any(state.get(k) is not None
               and not (isinstance(state[k], dict) and "step" in state[k])
               for k in _OPT_KEYS)


def checkpoint_params(state: dict,
                      device: Union[str, torch.device] = "cpu") -> dict:
    """The param trees of a loaded checkpoint of either package (those of
    its "ef_params", "w_params", "params", "arch", "bn_running" that it
    has) as the port's tensors on `device`; its optimizer states are not
    read."""
    trees = {k: state[k] for k in _PARAM_KEYS if state.get(k) is not None}
    return (checkpoint_from_jax(trees, device) if is_jax_checkpoint(state)
            else checkpoint_trees(trees, device))


def checkpoint_trees(state: dict, device: Union[str, torch.device] = "cpu",
                     arch_lr: float = 0.0) -> dict:
    """A loaded checkpoint of either package -> its param trees and
    optimizer states as the port's, tensors on `device`; a JAX package's
    is converted (`checkpoint_from_jax`, `arch_lr` the learning rate of
    its `arch_opt`, which optax does not store)."""
    if is_jax_checkpoint(state):
        return checkpoint_from_jax(state, device, arch_lr)
    out = dict(state)
    for k in _PARAM_KEYS:
        if out.get(k) is not None:
            out[k] = as_tensors(out[k], device)
    for k in _OPT_KEYS:
        if out.get(k) is not None:
            opt = out[k]
            out[k] = {"step": int(opt["step"]), "lr": float(opt["lr"]),
                      "m": as_tensors(opt["m"], device),
                      "v": as_tensors(opt["v"], device)}
    return out


def checkpoint_from_jax(state: dict, device: Union[str, torch.device] = "cpu",
                        arch_lr: float = 0.0) -> dict:
    """A checkpoint tree of the JAX package (as either loader returns it)
    -> the port's: param trees and optimizer states converted, everything
    else (epoch, config, version) as it is."""
    out = dict(state)
    for k in _PARAM_KEYS:
        if out.get(k) is not None:
            out[k] = from_jax(out[k], device)
    for k in _OPT_KEYS:
        if out.get(k) is not None:
            out[k] = opt_state_from_jax(out[k], device, lr=arch_lr)
    return out


def checkpoint_to_jax(state: dict, templates: dict) -> dict:
    """A checkpoint tree of the port -> the JAX package's; `templates`
    maps each optimizer key present to that optimizer's `.init` state."""
    out = dict(state)
    for k in _PARAM_KEYS:
        if out.get(k) is not None:
            out[k] = to_jax(as_tensors(out[k]))
    for k in _OPT_KEYS:
        if out.get(k) is not None:
            opt = dict(out[k], m=as_tensors(out[k]["m"]),
                       v=as_tensors(out[k]["v"]))
            out[k] = opt_state_to_jax(opt, templates[k])
    return out


def as_tensors(tree, device: Union[str, torch.device] = "cpu"):
    """numpy leaves in the port's own layout (a loaded port checkpoint's)
    -> tensors on `device`; tensors pass."""
    return _map(tree, lambda a: (a if isinstance(a, torch.Tensor)
                                 else torch.from_numpy(np.array(a))
                                 ).to(device))
