"""Model FLOPs of LCT training with PC-DARTS's ImageNet network as the EF's
image encoder (`reference/derived.py`), by `flops.py`'s convention:
products alone, two operations a multiply-add; BatchNorm, pooling and
elementwise work left out.

The trunk's products are counted from its layer list: the three stem
convolutions, each cell's preprocessing 1x1 convolutions, and each op of
the genotype (a sep_conv's two depthwise and two pointwise convolutions,
a dil_conv's one of each, a factorized reduce's two stride-2 1x1
convolutions; pools and the identity none). W and the LSTMs are
`flops.py`'s.
"""

from __future__ import annotations

from portbench import flops
from portbench.flops import conv_flops, linear_flops, lstm_flops
from portbench.reference import derived as D


def _out(hw: int, k: int, stride: int, pad: int, dilation: int = 1) -> int:
    return (hw + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def _fr(n: int, hw: int, c_in: int, c_out: int) -> float:
    """A factorized reduce on an hw x hw input."""
    return (conv_flops(n, _out(hw, 1, 2, 0), _out(hw, 1, 2, 0), c_in,
                       c_out // 2, 1, 1)
            + conv_flops(n, _out(hw - 1, 1, 2, 0), _out(hw - 1, 1, 2, 0),
                         c_in, c_out // 2, 1, 1))


def _op(name: str, n: int, hw: int, c: int, stride: int) -> float:
    if name == "skip_connect":
        return _fr(n, hw, c, c) if stride == 2 else 0.0
    if name.endswith("pool_3x3"):
        return 0.0
    k = int(name[-1])
    if name.startswith("sep_conv"):
        o = _out(hw, k, stride, k // 2)
        return 2 * (conv_flops(n, o, o, c, c, k, k, groups=c)
                    + conv_flops(n, o, o, c, c, 1, 1))
    o = _out(hw, k, stride, k - 1, 2)
    return (conv_flops(n, o, o, c, c, k, k, groups=c)
            + conv_flops(n, o, o, c, c, 1, 1))


def trunk_fwd_flops(m: dict, n: int) -> float:
    """The network's forward at batch n, the stems to the last cell."""
    c, img = m["darts_init_ch"], m["img_size"]
    h1 = _out(img, 3, 2, 1)
    h2 = _out(h1, 3, 2, 1)
    h3 = _out(h2, 3, 2, 1)
    total = (conv_flops(n, h1, h1, 3, c // 2, 3, 3)
             + conv_flops(n, h2, h2, c // 2, c, 3, 3)
             + conv_flops(n, h3, h3, c, c, 3, 3))
    g = D.genotype(m)
    hw0, hw1 = h2, h3
    for spec in D.cell_schedule(m):
        cc = spec["c"]
        if spec["reduction_prev"]:
            total += _fr(n, hw0, spec["c_pp"], cc)
        else:
            total += conv_flops(n, hw0, hw0, spec["c_pp"], cc, 1, 1)
        total += conv_flops(n, hw1, hw1, spec["c_p"], cc, 1, 1)
        out = _out(hw1, 1, 2, 0) if spec["reduction"] else hw1
        gene, _ = D._gene(g, spec["reduction"])
        for name, src in gene:
            # a node's own inputs are at the cell's output resolution
            stride = 2 if spec["reduction"] and src < 2 else 1
            total += _op(name, n, hw1 if src < 2 else out, cc, stride)
        hw0, hw1 = hw1, out
    return total


def ef_fwd_flops(m: dict, n: int) -> float:
    """The EF's teacher-forced forward with this network."""
    t, h, e = m["max_qst_len"], m["lstm_hidden_size"], m["word_embed_size"]
    emb = m["img_embed_size"]
    return (trunk_fwd_flops(m, n) + linear_flops(n, D.out_features(m), emb)
            + lstm_flops(n, t, e, h) + linear_flops(n, 2 * h, emb)
            + t * linear_flops(n, h, m["qst_vocab_size"])
            + linear_flops(n, emb, m["ans_vocab_size"])
            + linear_flops(n, m["ans_vocab_size"], m["ans_vocab_size"]))


def ef_generate_flops(m: dict, n: int) -> float:
    """Stage 2's generation: the image encoded, T decoder steps with their
    heads, the question encoded again and answered."""
    t, h = m["max_qst_len"], m["lstm_hidden_size"]
    return (ef_fwd_flops(m, n) + lstm_flops(n, t, m["word_embed_size"], h)
            + t * linear_flops(n, h, m["qst_vocab_size"]))


def lct_train_step(m: dict, n: int) -> float:
    """One stage-1 and one stage-2 step at batch n, as
    `flops.lct_train_step` counts them."""
    return (3 * ef_fwd_flops(m, n) + ef_generate_flops(m, n)
            + 2 * flops.w_fwd_flops(m, n)
            + 2 * 2 * flops._w_trainable_fwd(m, n))
