"""Parameter initializers and dense primitives (port of lctvqa/ops/nn.py).

Initializers draw from PyTorch's default distributions with an explicit
`torch.Generator`: Linear U(-k, k) with k = 1/sqrt(fan_in), Embedding
N(0, 1), xavier_uniform with zero bias for the EF question heads.

Params are nested dicts of fp32 tensors in the JAX package's layout:
linear weights stay [in, out] (not torch's [out, in]), so `linear` is
`x @ w + b` and the LSTM kernels read [in, 4H] rows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

f32 = torch.float32


def torch_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A config's `compute_dtype` string ("bfloat16", "float32", ...) as a
    torch dtype; empty or None means no cast, as in the JAX package."""
    if not name:
        return None
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown compute dtype {name!r}")
    return dt


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.empty(shape, dtype=f32).uniform_(-bound, bound,
                                                  generator=gen)


def torch_linear_init(gen: torch.Generator, in_features: int,
                      out_features: int):
    """weight [in, out], bias [out]."""
    k = 1.0 / math.sqrt(in_features)
    return {"w": uniform(gen, (in_features, out_features), k),
            "b": uniform(gen, (out_features,), k)}


def xavier_linear_init(gen: torch.Generator, in_features: int,
                       out_features: int):
    bound = math.sqrt(6.0 / (in_features + out_features))
    return {"w": uniform(gen, (in_features, out_features), bound),
            "b": torch.zeros(out_features, dtype=f32)}


def embedding_init(gen: torch.Generator, vocab_size: int, embed_dim: int):
    return {"table": torch.randn(vocab_size, embed_dim, generator=gen,
                                 dtype=f32)}


def prepare_linear(params, dtype: Optional[torch.dtype]):
    """A linear layer's params for repeated calls: the weight rounded to
    `dtype` once and kept fp32, so `linear` uses it as it is."""
    w = params["w"] if dtype is None else params["w"].to(dtype)
    return {"w": w.to(f32).contiguous(), "b": params["b"].to(f32),
            "rounded_to": dtype}


def linear(params, x: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ w + b with operands rounded to `dtype` and fp32 accumulation
    (JAX: jnp.dot(..., preferred_element_type=float32)). A weight from
    `prepare_linear` is rounded already."""
    w = params["w"]
    if "rounded_to" in params:
        if params["rounded_to"] != dtype:
            raise ValueError(f"weight prepared for {params['rounded_to']}, "
                             f"called with {dtype}")
    elif dtype is not None:
        w = w.to(dtype)
    if dtype is not None:
        x = x.to(dtype)
    return x.to(f32) @ w.to(f32) + params["b"].to(f32)


def embed(params, ids: torch.Tensor) -> torch.Tensor:
    """ids int [...] -> fp32 [..., embed_dim]."""
    return params["table"][ids.long()]


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout (torch.nn.Dropout semantics) drawing its mask from
    an explicit generator on x's device."""
    if deterministic or rate == 0.0:
        return x
    if gen is None:
        raise ValueError("dropout in train mode needs a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 0.0) -> torch.Tensor:
    """x / ||x||_2 with the norm treated as a constant (the reference
    detaches it)."""
    norm = x.detach().square().sum(dim, keepdim=True).sqrt() + eps
    return x / norm


def detach_tree(tree):
    """The same tree with every tensor detached (a frozen sub-model: its
    leaves get no gradient). Entries that are not tensors, such as a
    served model's prepared weights' dtype tags, pass as they are."""
    if not torch.is_grad_enabled():
        return tree
    if isinstance(tree, dict):
        return {k: detach_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(detach_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(detach_tree(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree
