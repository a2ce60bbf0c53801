"""Whole-loop greedy decode as one kernel.

Counterpart of `lctvqa/ops/pallas_generate.py`; the kernel is in
`lctvqa_torch/csrc/generate.cu`. It mirrors the model's greedy decode
(`models/qst_encoder.ef_qst_generate`): h0 = c0 = the image embedding,
x0 = tanh(table[<start>]); per step the LSTM cell, logits =
fc2(tanh h), the first maximum, and the next x = table[token] with no
tanh. Matmul operands are rounded to the compute dtype, sums are fp32,
the embedding rows stay fp32. Tokens are integers: no gradient.

On CPU tensors the plain version runs, which is the model's own decode
loop with the plain LSTM cell; on CUDA tensors the kernel launches or the
call raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lctvqa_torch.ops import _build as K
from lctvqa_torch.ops.cuda_lstm import CellWeights, cell_weights

f32 = torch.float32

GENERATE = K.register(K.Kernel("greedy_generate", "lctvqa_greedy_generate",
                               [K.PTR] * 9 + [K.INT] * 6))


def greedy_generate_plain(qst_params, image_embedding: torch.Tensor,
                          max_length: int,
                          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The decode loop in plain PyTorch. Returns int32 [B, max_length]."""
    from lctvqa_torch.models.qst_encoder import ef_qst_generate

    return ef_qst_generate(qst_params, image_embedding, max_length,
                           dtype=dtype, use_kernel=False,
                           use_generate_kernel=False)


class DecodeWeights(NamedTuple):
    """The decode's weights as the kernel takes them."""

    cell: CellWeights
    table: torch.Tensor  # [V, E] fp32 embedding table
    x0: torch.Tensor     # [E] fp32, tanh(table[<start>])
    fc2_w: torch.Tensor  # [H, V8] compute dtype, V padded to V8 = 8k
    fc2_b: torch.Tensor  # [V8] fp32, -inf in the padding


def decode_weights(qst_params,
                   dtype: Optional[torch.dtype] = None) -> DecodeWeights:
    """Cast and pad the decode's weights once. The kernel reads the head in
    8-column, 16-byte pieces, so V is padded to a multiple of 8 with
    columns that never win (weight 0, bias -inf). Question-encoder params
    that hold them under "decode" (a served model's) return them."""
    from lctvqa_torch.models.qst_encoder import START_TOKEN

    if "decode" in qst_params:
        d = qst_params["decode"]
        if d.cell.w_ih.dtype != (dtype or f32):
            raise ValueError(f"decode weights cast to {d.cell.w_ih.dtype}, "
                             f"called with {dtype}")
        return d
    layers = qst_params["lstm"]["layers"]
    K.check(len(layers) == 1, GENERATE.name, "needs num_layers=1")
    cell = cell_weights(layers[0], dtype)
    table = qst_params["word2vec"]["table"].to(f32).contiguous()
    fc2_w = qst_params["fc2"]["w"].to(cell.w_ih.dtype)
    fc2_b = qst_params["fc2"]["b"].to(f32)
    pad = -fc2_w.shape[1] % 8
    fc2_w = torch.nn.functional.pad(fc2_w, (0, pad)).contiguous()
    fc2_b = torch.cat([fc2_b, fc2_b.new_full((pad,), float("-inf"))])
    return DecodeWeights(cell, table,
                         torch.tanh(table[START_TOKEN]).contiguous(),
                         fc2_w, fc2_b)


def greedy_generate(qst_params, image_embedding: torch.Tensor,
                    max_length: int,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused greedy decode (replaces greedy_generate_pallas).
    image_embedding [B, H]; returns int32 tokens [B, max_length]."""
    if image_embedding.device.type == "cpu":
        return greedy_generate_plain(qst_params, image_embedding, max_length,
                                     dtype)
    name = GENERATE.name
    K.check(max_length >= 1, name, "needs max_length >= 1")
    d = decode_weights(qst_params, dtype)
    w = d.cell
    bsz = image_embedding.shape[0]
    h0 = image_embedding.reshape(bsz, -1).to(f32).contiguous()
    device = K.check_cuda_tensors(name, h0=h0, w_ih=w.w_ih, w_hh=w.w_hh,
                                  fc2_w=d.fc2_w, table=d.table)
    vocab, emb = d.table.shape
    hid = w.w_hh.shape[0]
    vpad = d.fc2_w.shape[1]
    code = K.dtype_code(name, w.w_ih.dtype)
    K.check(w.w_ih.shape == (emb, 4 * hid), name,
            f"w_ih must be [{emb}, {4 * hid}]")
    K.check(emb + 4 * hid <= 8192 and hid <= 1024, name,
            f"E={emb}, H={hid} too large (needs E + 4H <= 8192, H <= 1024)")
    K.check(h0.shape == (bsz, hid), name,
            f"image embedding must be [{bsz}, {hid}] (h0 = c0)")
    K.check(d.fc2_w.shape[0] == hid and vpad % 8 == 0
            and 0 <= vpad - vocab < 8 and d.fc2_b.shape == (vpad,), name,
            f"fc2 must map {hid} -> {vocab}, padded to a multiple of 8")
    K.check(d.fc2_w.is_contiguous() and d.fc2_w.data_ptr() % 16 == 0, name,
            "fc2 weight must be contiguous and 16-byte aligned")
    tokens = torch.empty(bsz, max_length, dtype=torch.int32, device=device)
    if bsz:
        GENERATE.launch(device, h0, d.x0, w.w_ih, w.w_hh, w.b, d.fc2_w,
                        d.fc2_b, d.table, tokens, bsz, max_length, emb, hid,
                        vpad, code)
    return tokens
