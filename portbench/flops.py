"""Model FLOPs of the cells' work, and the card's peak (frozen here, so
that a change to the program cannot change the yardstick).

Only products are counted (convolutions, matrix products, the LSTM gate
products), two operations a multiply-add; elementwise work, BatchNorm's
statistics and pooling are left out, as the usual MFU convention does.
The counts follow the layers' shapes: VGG19 ('E'), the PC-DARTS search
network with every primitive on the 1/k partial channels of every edge,
the question LSTMs and the heads. A configuration is the dict of a
`portbench/configs/*.json` file's "model".
"""

from __future__ import annotations

from portbench.reference.model import OUTPUT_SIZE, PRIMITIVES, VGG19_CFG
from portbench.reference.model import cell_schedule

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core FLOP/s
H100_BF16_PEAK = 989e12


def conv_flops(n, h_out, w_out, c_in, c_out, kh, kw, groups=1) -> float:
    return 2.0 * n * h_out * w_out * (c_in // groups) * kh * kw * c_out


def linear_flops(n, d_in, d_out) -> float:
    return 2.0 * n * d_in * d_out


def lstm_flops(n, t, d_in, hidden) -> float:
    return t * 2.0 * n * (d_in + hidden) * 4 * hidden


def vgg19_fwd_flops(n: int, img: int, width_mult: float = 1.0,
                    fc_dim: int = 4096) -> float:
    total, c_in, hw = 0.0, 3, img
    for v in VGG19_CFG:
        if v == "M":
            hw //= 2
            continue
        c_out = max(1, int(v * width_mult))
        total += conv_flops(n, hw, hw, c_in, c_out, 3, 3)
        c_in = c_out
    total += linear_flops(n, c_in * 7 * 7, fc_dim)
    total += linear_flops(n, fc_dim, fc_dim)
    return total


def vgg19_conv_flops(n: int, img: int) -> float:
    """The convolutions alone (the fully connected layers left out)."""
    return vgg19_fwd_flops(n, img) - linear_flops(n, 512 * 49, 4096) \
        - linear_flops(n, 4096, 4096)


def _op_flops(prim: str, n: int, hw: int, ch: int, stride: int) -> float:
    out = hw // stride
    if prim.startswith("sep_conv"):
        k = int(prim[-1])
        return 2 * (conv_flops(n, out, out, ch, ch, k, k, groups=ch)
                    + conv_flops(n, out, out, ch, ch, 1, 1))
    if prim.startswith("dil_conv"):
        k = int(prim[-1])
        return (conv_flops(n, out, out, ch, ch, k, k, groups=ch)
                + conv_flops(n, out, out, ch, ch, 1, 1))
    if prim == "skip_connect" and stride != 1:
        return 2 * conv_flops(n, out, out, ch, ch // 2, 1, 1)
    return 0.0


def darts_fwd_flops(m: dict, n: int) -> float:
    """The search network's forward: the stem, each cell's preprocessing
    1x1 convolutions, all eight primitives on the 1/k partial channels of
    every edge, and the adaptive pool (as two products)."""
    img, k = m["img_size"], m["darts_partial_k"]
    total = conv_flops(n, img, img, 3,
                       m["darts_stem_multiplier"] * m["darts_init_ch"], 3, 3)
    hw = img
    for spec in cell_schedule(m):
        c = spec["c"]
        in_hw = hw
        out_hw = hw // 2 if spec["reduction"] else hw
        if spec["reduction_prev"]:
            total += 2 * conv_flops(n, in_hw, in_hw, spec["c_pp"], c // 2,
                                    1, 1)
        else:
            total += conv_flops(n, in_hw, in_hw, spec["c_pp"], c, 1, 1)
        total += conv_flops(n, in_hw, in_hw, spec["c_p"], c, 1, 1)
        for i in range(m["darts_steps"]):
            for j in range(2 + i):
                stride = 2 if spec["reduction"] and j < 2 else 1
                edge_hw = in_hw if stride == 2 else out_hw
                for prim in PRIMITIVES:
                    total += _op_flops(prim, n, edge_hw, c // k, stride)
        hw = out_hw
    c_prev = m["darts_multiplier"] * cell_schedule(m)[-1]["c"]
    total += 2.0 * n * OUTPUT_SIZE * hw * hw * c_prev
    total += 2.0 * n * OUTPUT_SIZE * OUTPUT_SIZE * hw * c_prev
    return total


def _w_trainable_fwd(m: dict, n: int) -> float:
    """W's products outside the frozen trunk."""
    total = linear_flops(n, m["vgg_fc_dim"], m["img_embed_size"])
    total += lstm_flops(n, m["max_qst_len"], m["word_embed_size"],
                        m["lstm_hidden_size"])
    total += linear_flops(n, 2 * m["lstm_hidden_size"], m["img_embed_size"])
    total += linear_flops(n, m["img_embed_size"], m["ans_vocab_size"])
    total += linear_flops(n, m["ans_vocab_size"], m["ans_vocab_size"])
    return total


def w_fwd_flops(m: dict, n: int) -> float:
    return (vgg19_fwd_flops(n, m["img_size"], m["vgg_width_mult"],
                            m["vgg_fc_dim"]) + _w_trainable_fwd(m, n))


def ef_fwd_flops(m: dict, n: int) -> float:
    """The EF's teacher-forced forward with the search network."""
    t, h, e = m["max_qst_len"], m["lstm_hidden_size"], m["word_embed_size"]
    feat = m["darts_multiplier"] * cell_schedule(m)[-1]["c"] * 49
    total = darts_fwd_flops(m, n) + linear_flops(n, feat, m["img_embed_size"])
    total += lstm_flops(n, t, e, h)
    total += linear_flops(n, 2 * h, m["img_embed_size"])
    total += t * linear_flops(n, h, m["qst_vocab_size"])
    total += linear_flops(n, m["img_embed_size"], m["ans_vocab_size"])
    total += linear_flops(n, m["ans_vocab_size"], m["ans_vocab_size"])
    return total


def ef_generate_flops(m: dict, n: int) -> float:
    """The served `generate`: the image encoded, T decoder steps with
    their heads, the question encoded again (its teacher-forced heads
    computed too) and answered."""
    t, h = m["max_qst_len"], m["lstm_hidden_size"]
    loop = (lstm_flops(n, t, m["word_embed_size"], h)
            + t * linear_flops(n, h, m["qst_vocab_size"]))
    return ef_fwd_flops(m, n) + loop


def lct_train_step(m: dict, n: int) -> float:
    """One stage-1 and one stage-2 step at batch n: the EF's forward and
    backward (three forwards' worth), the EF's sampled generation without
    gradient, and W's two forwards with the backward of its parts outside
    the frozen trunk (two forwards' worth of those parts each)."""
    return (3 * ef_fwd_flops(m, n) + ef_generate_flops(m, n)
            + 2 * w_fwd_flops(m, n) + 2 * 2 * _w_trainable_fwd(m, n))
