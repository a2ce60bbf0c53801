"""Genotype resolution and the decode CLI (the port's own copy of
lctvqa/genotype.py).

- ``--genotype`` (lctvqa_torch/main.py, eval.py, serve.py) takes a preset
  NAME (``PC_DARTS_cifar``), a search CHECKPOINT of either package
  (``ef_model.ckpt``; its arch parameters are decoded on the spot with
  the steps and multiplier of the checkpoint's own config), or a TEXT
  FILE holding a ``Genotype(...)`` repr (one copied from a search log).
- ``python -m lctvqa_torch.genotype <checkpoint> [-o genotype.txt]``
  decodes and prints a searched genotype, for a look or a later retrain.
"""

from __future__ import annotations

import argparse
import os

from lctvqa_torch.models import genotypes
from lctvqa_torch.models.genotypes import Genotype


def parse_genotype_repr(text: str) -> Genotype:
    """Parse a ``Genotype(...)`` repr (as printed in search logs)."""
    ns = {"Genotype": Genotype, "range": range}
    g = eval(text.strip(), {"__builtins__": {}}, ns)  # noqa: S307
    if not isinstance(g, Genotype):
        raise ValueError(f"not a Genotype repr: {text[:80]!r}")
    return g


def genotype_from_checkpoint(path: str) -> Genotype:
    """Decode the arch parameters of a search checkpoint (``ef_model.ckpt``
    of the LCT loop) written by either package."""
    from lctvqa_torch.models import search
    from lctvqa_torch.train import checkpoint

    state = checkpoint.load_state(path)
    if not isinstance(state, dict) or state.get("arch") is None:
        raise ValueError(f"{path} holds no arch parameters (fixed-arch or "
                         "W-model checkpoint?)")
    cfg = checkpoint.config_from_state(state)
    steps = cfg.model.darts_steps if cfg is not None else 4
    multiplier = cfg.model.darts_multiplier if cfg is not None else 4
    return search.genotype(state["arch"], steps, multiplier)


def resolve_genotype(spec: str) -> Genotype:
    """``--genotype`` value -> Genotype: preset name | checkpoint path |
    text file with a Genotype repr."""
    preset = getattr(genotypes, spec, None)
    if isinstance(preset, Genotype):
        return preset
    if os.path.exists(spec):
        try:
            return genotype_from_checkpoint(spec)
        except Exception:
            with open(spec) as f:
                return parse_genotype_repr(f.read())
    names = [n for n in dir(genotypes)
             if isinstance(getattr(genotypes, n), Genotype)]
    raise ValueError(
        f"--genotype {spec!r}: not a preset ({', '.join(sorted(names))}), "
        "an existing checkpoint, or a Genotype-repr file")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Decode the searched genotype from a checkpoint")
    p.add_argument("checkpoint", help="ef_model.ckpt of a search run")
    p.add_argument("-o", "--out", default="",
                   help="also write the repr to this file (usable later "
                        "via --genotype <file>)")
    p.add_argument("--trusted", action="store_true",
                   help="the JAX package's flag for legacy pickle "
                        "checkpoints; the port reads only ZIP checkpoints "
                        "and refuses a pickle with or without it")
    args = p.parse_args(argv)
    g = genotype_from_checkpoint(args.checkpoint)
    print(repr(g))
    if args.out:
        with open(args.out, "w") as f:
            f.write(repr(g) + "\n")


if __name__ == "__main__":
    main()
