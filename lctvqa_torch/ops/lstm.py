"""LSTM: torch gate order (i, f, g, o), a Python loop over time (port of
lctvqa/ops/lstm.py). Weights are [in, 4H], as in the JAX package.

Each step runs the fused cell kernel (`use_kernel`, the config's
`use_pallas_lstm`) or its plain version; the whole-sequence kernels are
called by the question encoders directly.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from lctvqa_torch.ops import cuda_lstm
from lctvqa_torch.ops.cuda_lstm import CellWeights, cell_weights
from lctvqa_torch.ops.nn import uniform


def lstm_init(gen: torch.Generator, input_size: int, hidden_size: int,
              num_layers: int = 1):
    """Torch init U(-k, k), k = 1/sqrt(H); w_ih [in, 4H], w_hh [H, 4H]."""
    k = 1.0 / math.sqrt(hidden_size)
    layers = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else hidden_size
        layers.append({
            "w_ih": uniform(gen, (in_sz, 4 * hidden_size), k),
            "w_hh": uniform(gen, (hidden_size, 4 * hidden_size), k),
            "b_ih": uniform(gen, (4 * hidden_size,), k),
            "b_hh": uniform(gen, (4 * hidden_size,), k),
        })
    return {"layers": layers}


def lstm_cell(w: CellWeights, x, h, c, use_kernel: bool = False):
    """One step: the cell kernel, or its plain version."""
    if use_kernel:
        return cuda_lstm.lstm_cell(w, x, h, c)
    return cuda_lstm.lstm_cell_plain(w, x, h, c)


def lstm(params, xs: torch.Tensor, h0: Optional[torch.Tensor] = None,
         c0: Optional[torch.Tensor] = None,
         dtype: Optional[torch.dtype] = None, use_kernel: bool = False):
    """A (possibly stacked) LSTM over a batch-major sequence.

    xs [B, T, in]; h0/c0 [num_layers, B, H] or None (zeros).
    Returns (outputs [B, T, H], (h_n, c_n) each [num_layers, B, H]).
    """
    layers = params["layers"]
    b = xs.shape[0]
    hid = layers[0]["w_hh"].shape[0]
    zeros = torch.zeros(len(layers), b, hid, dtype=torch.float32,
                        device=xs.device)
    h0 = zeros if h0 is None else h0
    c0 = zeros if c0 is None else c0
    seq = xs
    h_ns, c_ns = [], []
    for layer, lp in enumerate(layers):
        w = cell_weights(lp, dtype)
        h, c = h0[layer], c0[layer]
        outs = []
        for t in range(seq.shape[1]):
            h, c = lstm_cell(w, seq[:, t], h, c, use_kernel)
            outs.append(h)
        seq = torch.stack(outs, 1)
        h_ns.append(h)
        c_ns.append(c)
    return seq, (torch.stack(h_ns), torch.stack(c_ns))
