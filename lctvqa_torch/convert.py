"""Parameter layouts: the JAX package's pytree (numpy) <-> the port's.

The port keeps the JAX package's tree structure (dicts, lists, tuples)
and its layouts with one exception:

- conv weights, the only 4-D leaves: HWIO (JAX) <-> OIHW (torch). The one
  rule covers every conv of the search tree: a depthwise [k, k, 1, C]
  becomes [C, 1, k, k], a 1x7 [1, 7, ci, co] becomes [co, ci, 1, 7], a
  7x1 likewise;
- arch parameters (alphas [edges, 8], betas [edges]) stay as they are;
- linear weights stay [in, out] in both, so the port computes x @ w;
- LSTM w_ih [in, 4H] and w_hh [H, 4H] stay as they are, with b_ih and
  b_hh kept separate;
- embedding tables stay as they are.

Both directions copy values exactly, so a round trip is exact.
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
