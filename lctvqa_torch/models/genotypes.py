"""Genotype container + primitive op set (reference `pcdarts/genotypes.py`;
the port's own copy of lctvqa/models/genotypes.py).

The preset genotypes are the published constants from the DARTS / PC-DARTS
papers, included so a searched architecture can be compared against them and
so `derive`d networks can be built from known-good cells.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple


class Genotype(NamedTuple):
    normal: Sequence[Tuple[str, int]]
    normal_concat: Sequence[int]
    reduce: Sequence[Tuple[str, int]]
    reduce_concat: Sequence[int]


PRIMITIVES = (
    "none",
    "max_pool_3x3",
    "avg_pool_3x3",
    "skip_connect",
    "sep_conv_3x3",
    "sep_conv_5x5",
    "dil_conv_3x3",
    "dil_conv_5x5",
)

NONE_IDX = PRIMITIVES.index("none")

# NASNet-A / AmoebaNet-B cells (published constants from the NASNet and
# AmoebaNet papers, shipped by the reference at pcdarts/genotypes.py:16-72).
# Both are NON-uniform: 5 nodes per cell and different concat widths for
# normal vs reduce; a derived network handles that with a
# genotype-aware channel schedule.
NASNet = Genotype(
    normal=[("sep_conv_5x5", 1), ("sep_conv_3x3", 0), ("sep_conv_5x5", 0),
            ("sep_conv_3x3", 0), ("avg_pool_3x3", 1), ("skip_connect", 0),
            ("avg_pool_3x3", 0), ("avg_pool_3x3", 0), ("sep_conv_3x3", 1),
            ("skip_connect", 1)],
    normal_concat=[2, 3, 4, 5, 6],
    reduce=[("sep_conv_5x5", 1), ("sep_conv_7x7", 0), ("max_pool_3x3", 1),
            ("sep_conv_7x7", 0), ("avg_pool_3x3", 1), ("sep_conv_5x5", 0),
            ("skip_connect", 3), ("avg_pool_3x3", 2), ("sep_conv_3x3", 2),
            ("max_pool_3x3", 1)],
    reduce_concat=[4, 5, 6],
)

AmoebaNet = Genotype(
    normal=[("avg_pool_3x3", 0), ("max_pool_3x3", 1), ("sep_conv_3x3", 0),
            ("sep_conv_5x5", 2), ("sep_conv_3x3", 0), ("avg_pool_3x3", 3),
            ("sep_conv_3x3", 1), ("skip_connect", 1), ("skip_connect", 0),
            ("avg_pool_3x3", 1)],
    normal_concat=[4, 5, 6],
    reduce=[("avg_pool_3x3", 0), ("sep_conv_3x3", 1), ("max_pool_3x3", 0),
            ("sep_conv_7x7", 2), ("sep_conv_7x7", 0), ("avg_pool_3x3", 1),
            ("max_pool_3x3", 0), ("max_pool_3x3", 1), ("conv_7x1_1x7", 0),
            ("sep_conv_3x3", 5)],
    reduce_concat=[3, 4, 6],
)

DARTS_V1 = Genotype(
    normal=[("sep_conv_3x3", 1), ("sep_conv_3x3", 0), ("skip_connect", 0),
            ("sep_conv_3x3", 1), ("skip_connect", 0), ("sep_conv_3x3", 1),
            ("sep_conv_3x3", 0), ("skip_connect", 2)],
    normal_concat=[2, 3, 4, 5],
    reduce=[("max_pool_3x3", 0), ("max_pool_3x3", 1), ("skip_connect", 2),
            ("max_pool_3x3", 0), ("max_pool_3x3", 0), ("skip_connect", 2),
            ("skip_connect", 2), ("avg_pool_3x3", 0)],
    reduce_concat=[2, 3, 4, 5],
)

DARTS_V2 = Genotype(
    normal=[("sep_conv_3x3", 0), ("sep_conv_3x3", 1), ("sep_conv_3x3", 0),
            ("sep_conv_3x3", 1), ("sep_conv_3x3", 1), ("skip_connect", 0),
            ("skip_connect", 0), ("dil_conv_3x3", 2)],
    normal_concat=[2, 3, 4, 5],
    reduce=[("max_pool_3x3", 0), ("max_pool_3x3", 1), ("skip_connect", 2),
            ("max_pool_3x3", 1), ("max_pool_3x3", 0), ("skip_connect", 2),
            ("skip_connect", 2), ("max_pool_3x3", 1)],
    reduce_concat=[2, 3, 4, 5],
)

PC_DARTS_cifar = Genotype(
    normal=[("sep_conv_3x3", 1), ("skip_connect", 0), ("sep_conv_3x3", 0),
            ("dil_conv_3x3", 1), ("sep_conv_5x5", 0), ("sep_conv_3x3", 1),
            ("avg_pool_3x3", 0), ("dil_conv_3x3", 1)],
    normal_concat=list(range(2, 6)),
    reduce=[("sep_conv_5x5", 1), ("max_pool_3x3", 0), ("sep_conv_5x5", 1),
            ("sep_conv_5x5", 2), ("sep_conv_3x3", 0), ("sep_conv_3x3", 3),
            ("sep_conv_3x3", 1), ("sep_conv_3x3", 2)],
    reduce_concat=list(range(2, 6)),
)

PC_DARTS_image = Genotype(
    normal=[("skip_connect", 1), ("sep_conv_3x3", 0), ("sep_conv_3x3", 0),
            ("skip_connect", 1), ("sep_conv_3x3", 1), ("sep_conv_3x3", 3),
            ("sep_conv_3x3", 1), ("dil_conv_5x5", 4)],
    normal_concat=list(range(2, 6)),
    reduce=[("sep_conv_3x3", 0), ("skip_connect", 1), ("dil_conv_5x5", 2),
            ("max_pool_3x3", 1), ("sep_conv_3x3", 2), ("sep_conv_3x3", 1),
            ("sep_conv_5x5", 0), ("sep_conv_3x3", 3)],
    reduce_concat=list(range(2, 6)),
)

PCDARTS = PC_DARTS_cifar
