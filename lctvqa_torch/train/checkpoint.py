"""Checkpoint / resume (port of lctvqa/train/checkpoint.py).

The same pickle-free file: a ZIP of raw little-endian leaf bytes and a
JSON skeleton of the containers. The port writes dicts, lists, tuples,
scalars and arrays, and tags its config dataclasses and its `Genotype`
with the JAX package's names for them (`lctvqa.config` / `Config` and so
on, `lctvqa.models.genotypes` / `Genotype`; strings only, nothing is
imported), so the JAX package's loader rebuilds them as its own classes:
the port's config fields are a subset of that package's, but for those
of `PORT_ONLY`, written only where they differ from their default (a
model that package cannot build then fails to load there). The port's
loader reads the files of either package: a namedtuple node (an optax
optimizer state, a Genotype) becomes a `NamedTupleNode` that keeps its
class name and values, a dataclass node (a Config) a dict of its fields.
Nothing named in a file is ever imported. `config_from_state` turns a
checkpoint's config, of either package, into the port's `Config`;
`lctvqa_torch.convert` turns the trees of either package into the
other's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from lctvqa_torch import config as port_config
from lctvqa_torch.models.genotypes import Genotype


class NamedTupleNode(NamedTuple):
    """A namedtuple of a foreign checkpoint: its class and its values."""

    module: str
    name: str
    values: tuple


# config fields the JAX package does not have, and their defaults
PORT_ONLY = {"derived_skeleton": "search"}


def _jax_module(mod: str) -> str:
    """The JAX package's module of the same name: lctvqa_torch.x ->
    lctvqa.x."""
    root, _, rest = mod.partition(".")
    return "lctvqa." + rest if root == "lctvqa_torch" else mod


def _encode(obj: Any, leaves: list):
    """Object -> JSON-safe skeleton; array leaves appended to `leaves`."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"py": obj}
    if isinstance(obj, dict):
        return {"d": {str(k): _encode(v, leaves) for k, v in obj.items()}}
    if isinstance(obj, NamedTupleNode):
        return {"nt": {"mod": obj.module, "name": obj.name,
                       "v": [_encode(v, leaves) for v in obj.values]}}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # a Genotype
        cls = type(obj)
        return {"nt": {"mod": _jax_module(cls.__module__),
                       "name": cls.__qualname__,
                       "v": [_encode(v, leaves) for v in obj]}}
    if isinstance(obj, list):
        return {"l": [_encode(v, leaves) for v in obj]}
    if isinstance(obj, tuple):
        return {"tu": [_encode(v, leaves) for v in obj]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        return {"dc": {"mod": _jax_module(cls.__module__),
                       "name": cls.__qualname__,
                       "f": {f.name: _encode(getattr(obj, f.name), leaves)
                             for f in dataclasses.fields(obj)
                             if f.name not in PORT_ONLY
                             or getattr(obj, f.name) != PORT_ONLY[f.name]}}}
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    leaves.append(np.asarray(obj))
    return {"a": len(leaves) - 1}


def _decode(skel, leaves: list):
    if "py" in skel:
        return skel["py"]
    if "a" in skel:
        return leaves[skel["a"]]
    if "d" in skel:
        return {k: _decode(v, leaves) for k, v in skel["d"].items()}
    if "l" in skel:
        return [_decode(v, leaves) for v in skel["l"]]
    if "tu" in skel:
        return tuple(_decode(v, leaves) for v in skel["tu"])
    if "nt" in skel:
        return NamedTupleNode(
            skel["nt"]["mod"], skel["nt"]["name"],
            tuple(_decode(v, leaves) for v in skel["nt"]["v"]))
    if "dc" in skel:
        return {k: _decode(v, leaves) for k, v in skel["dc"]["f"].items()}
    raise ValueError(f"unknown checkpoint skeleton node: {list(skel)}")


def save_state(path: str, state: Any, config: Optional[Any] = None) -> None:
    """Write `state` (containers of tensors, arrays and scalars) to
    `path`; `config` is embedded under "config" with the port's
    version."""
    if config is not None and "config" not in state:
        from lctvqa_torch import __version__
        state = dict(state, config=config, lctvqa_version=__version__)
    leaves: list = []
    skeleton = _encode(state, leaves)
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as z:
        z.writestr("tree.json", json.dumps(
            {"version": 1, "skeleton": skeleton,
             "leaves": [{"dtype": a.dtype.name, "shape": list(a.shape)}
                        for a in leaves]}))
        for i, a in enumerate(leaves):
            z.writestr(f"leaves/{i}", np.ascontiguousarray(a).tobytes())
    os.replace(tmp, path)


def load_state(path: str) -> Any:
    """-> the tree with numpy array leaves. Only the ZIP format loads:
    nothing from the file is executed."""
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path} is not a ZIP checkpoint (a legacy pickle "
                         "checkpoint is not loaded by the port)")
    with zipfile.ZipFile(path) as z:
        tree = json.loads(z.read("tree.json"))
        leaves = [
            np.frombuffer(z.read(f"leaves/{i}"),
                          np.dtype(spec["dtype"])).reshape(spec["shape"])
            for i, spec in enumerate(tree["leaves"])]
    return _decode(tree["skeleton"], leaves)


_SECTIONS = {"model": port_config.ModelConfig,
             "train": port_config.TrainConfig,
             "data": port_config.DataConfig,
             "mesh": port_config.MeshConfig}


def _dataclass_from(cls, fields: dict):
    """A config dataclass of the port from a checkpoint's dict of fields
    (nested sections, a genotype as the NamedTupleNode of either
    package's Genotype)."""
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"checkpoint config has {cls.__name__} fields the "
                         f"port does not know: {sorted(unknown)}")
    kw = {k: v for k, v in fields.items() if k in known}
    if cls is port_config.Config:
        for name, sub in _SECTIONS.items():
            if name in kw:
                kw[name] = _dataclass_from(sub, kw[name])
    elif isinstance(kw.get("genotype"), NamedTupleNode):
        kw["genotype"] = Genotype(*kw["genotype"].values)
    return cls(**kw)


def config_from_state(state) -> Optional[port_config.Config]:
    """The port's Config of a loaded checkpoint of either package (its
    "config" entry, a dict of fields as `load_state` returns it), or None
    where the file has none. Fields the port does not have raise."""
    cfg = state.get("config") if isinstance(state, dict) else None
    if cfg is None:
        return None
    return _dataclass_from(port_config.Config, cfg)


def exists(path: str) -> bool:
    return os.path.exists(path)
