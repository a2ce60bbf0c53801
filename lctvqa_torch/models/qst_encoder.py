"""Question encoders (port of lctvqa/models/qst_encoder.py).

- W-style encoder: embed -> tanh -> LSTM from zero state -> cat(h_n, c_n)
  -> tanh -> fc -> question feature.
- EF-style encoder/decoder: the LSTM's initial h and c are BOTH the image
  embedding; the teacher-forced forward also emits per-step vocab logits;
  `ef_qst_generate` decodes greedily.

Kernel flags: `use_kernel` runs every LSTM step through the cell kernel,
`use_seq_kernel` runs a one-layer recurrence as one sequence kernel, and
`use_generate_kernel` runs the whole greedy decode as one kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from lctvqa_torch.ops import cuda_lstm
from lctvqa_torch.ops import nn as N
from lctvqa_torch.ops.cuda_lstm import cell_weights
from lctvqa_torch.ops.lstm import lstm, lstm_cell, lstm_init

START_TOKEN = 2  # <start> id (the vocab builder puts it at index 2)


def w_qst_encoder_init(gen, qst_vocab_size, word_embed_size, embed_size,
                       num_layers, hidden_size):
    return {
        "word2vec": N.embedding_init(gen, qst_vocab_size, word_embed_size),
        "lstm": lstm_init(gen, word_embed_size, hidden_size, num_layers),
        "fc": N.torch_linear_init(gen, 2 * num_layers * hidden_size,
                                  embed_size),
    }


def w_qst_encoder(params, question: torch.Tensor,
                  dtype: Optional[torch.dtype] = None,
                  use_kernel: bool = False,
                  use_seq_kernel: bool = False) -> torch.Tensor:
    """question int [B, T] -> [B, embed_size]."""
    b = question.shape[0]
    x = torch.tanh(N.embed(params["word2vec"], question))
    layers = params["lstm"]["layers"]
    if use_seq_kernel and len(layers) == 1:
        # only the final (h, c) is used, so the recurrence is one kernel
        h_n, c_n = cuda_lstm.lstm_seq_final(cell_weights(layers[0], dtype), x)
        feat = torch.cat([h_n, c_n], 1)
    else:
        _, (h_n, c_n) = lstm(params["lstm"], x, dtype=dtype,
                             use_kernel=use_kernel)
        # cat(h, c) along features, [L, B, 2H] -> [B, L*2H]
        feat = torch.cat([h_n, c_n], 2).transpose(0, 1).reshape(b, -1)
    return N.linear(params["fc"], torch.tanh(feat), dtype=dtype)


def ef_qst_encoder_init(gen, qst_vocab_size, word_embed_size, embed_size,
                        num_layers, hidden_size):
    """fc1/fc2 use xavier_uniform and zero bias."""
    return {
        "word2vec": N.embedding_init(gen, qst_vocab_size, word_embed_size),
        "lstm": lstm_init(gen, word_embed_size, hidden_size, num_layers),
        "fc1": N.xavier_linear_init(gen, 2 * num_layers * hidden_size,
                                    embed_size),
        "fc2": N.xavier_linear_init(gen, hidden_size, qst_vocab_size),
    }


def ef_qst_encoder(params, question: torch.Tensor,
                   image_embedding: torch.Tensor,
                   dtype: Optional[torch.dtype] = None,
                   use_kernel: bool = False, use_seq_kernel: bool = False):
    """Teacher-forced forward conditioned on the image.

    Returns (qst_feature [B, embed], qst_logits [B, T, V]). The image
    embedding seeds both h0 and c0, so hidden_size equals the image embed
    size.
    """
    b = question.shape[0]
    x = torch.tanh(N.embed(params["word2vec"], question))
    layers = params["lstm"]["layers"]
    if use_seq_kernel and len(layers) == 1:
        h0 = image_embedding.reshape(b, -1)
        outs, (h_n, c_n) = cuda_lstm.lstm_seq(cell_weights(layers[0], dtype),
                                              x, h0, h0)
        feat = torch.cat([h_n, c_n], 1)
    else:
        h0 = image_embedding.reshape(1, b, -1)
        outs, (h_n, c_n) = lstm(params["lstm"], x, h0=h0, c0=h0, dtype=dtype,
                                use_kernel=use_kernel)
        feat = torch.cat([h_n, c_n], 2).transpose(0, 1).reshape(b, -1)
    qst_feature = N.linear(params["fc1"], torch.tanh(feat), dtype=dtype)
    qst_logits = N.linear(params["fc2"], torch.tanh(outs), dtype=dtype)
    return qst_feature, qst_logits


def ef_qst_generate(params, image_embedding: torch.Tensor, max_length: int,
                    dtype: Optional[torch.dtype] = None,
                    use_kernel: bool = False,
                    use_generate_kernel: bool = False) -> torch.Tensor:
    """Greedy question generation. Returns int32 tokens [B, max_length].

    The `<start>` embedding gets a tanh but the embeddings of generated
    tokens do not: a reference quirk kept for parity. Temperature sampling
    belongs to training and is not ported yet.
    """
    layers = params["lstm"]["layers"]
    if len(layers) != 1:
        raise ValueError("generate needs num_layers=1")
    if use_generate_kernel:
        from lctvqa_torch.ops import cuda_generate
        return cuda_generate.greedy_generate(params, image_embedding,
                                             max_length, dtype=dtype)
    w = cell_weights(layers[0], dtype)
    b = image_embedding.shape[0]
    h = c = image_embedding.reshape(b, -1).to(torch.float32)
    start = torch.full((b,), START_TOKEN, dtype=torch.long,
                       device=image_embedding.device)
    x = torch.tanh(N.embed(params["word2vec"], start))
    tokens = []
    for _ in range(max_length):
        h, c = lstm_cell(w, x, h, c, use_kernel)
        logits = N.linear(params["fc2"], torch.tanh(h), dtype=dtype)
        tok = torch.argmax(logits, dim=-1)  # first maximum, as jnp.argmax
        tokens.append(tok)
        x = N.embed(params["word2vec"], tok)  # no tanh (quirk, see above)
    return torch.stack(tokens, 1).to(torch.int32)
