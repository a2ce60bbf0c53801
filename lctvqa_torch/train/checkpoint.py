"""Checkpoint / resume (port of lctvqa/train/checkpoint.py).

The same pickle-free file: a ZIP of raw little-endian leaf bytes and a
JSON skeleton of the containers. The port writes plain dicts, lists,
tuples, scalars and arrays only (a config goes in as nested dicts), so
the JAX package's loader reads a port checkpoint with nothing to
resolve. The port's loader reads the JAX package's files as well: a
namedtuple node (an optax optimizer state) becomes a `NamedTupleNode`
that keeps its class name and values, a dataclass node (a Config) a
dict of its fields. Nothing named in a file is ever imported.
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


class NamedTupleNode(NamedTuple):
    """A namedtuple of a foreign checkpoint: its class and its values."""

    module: str
    name: str
    values: tuple


def _encode(obj: Any, leaves: list):
    """Object -> JSON-safe skeleton; array leaves appended to `leaves`."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"py": obj}
    if isinstance(obj, dict):
        return {"d": {str(k): _encode(v, leaves) for k, v in obj.items()}}
    if isinstance(obj, NamedTupleNode):
        return {"nt": {"mod": obj.module, "name": obj.name,
                       "v": [_encode(v, leaves) for v in obj.values]}}
    if isinstance(obj, list):
        return {"l": [_encode(v, leaves) for v in obj]}
    if isinstance(obj, tuple):
        return {"tu": [_encode(v, leaves) for v in obj]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _encode(dataclasses.asdict(obj), leaves)
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


def exists(path: str) -> bool:
    return os.path.exists(path)
