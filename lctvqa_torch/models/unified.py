"""The unified QA-stream model (port of lctvqa/models/unified.py): one
token stream `<start> question <sep> answer <end> <pad>...` read and
written by one LSTM whose initial h and c are both the image embedding,
trained with next-token cross entropy alone; there is no answer head.

`cfg.qst_vocab_size` is the unified vocabulary's size. The image encoder
is the PC-DARTS supernet (`arch_type="darts"`, with its arch parameters)
or VGG19 (`"fixed"`); `params["qa"]` holds `word2vec`, `lstm` and the
vocabulary head `fc2`, xavier-initialized with a zero bias.

Kernel flags: with `pallas_seq_lstm` a one-layer forward is one call of
the sequence kernel (`cuda_lstm.lstm_seq`), otherwise every step runs
the cell kernel (`use_pallas_lstm`) or its plain version; with
`pallas_generate` the greedy stream is one call of the decode kernel
over the unified vocabulary.
"""

from __future__ import annotations

from typing import Optional

import torch

from lctvqa_torch.config import ModelConfig
from lctvqa_torch.models import search, vgg
from lctvqa_torch.models.qst_encoder import ef_qst_generate
from lctvqa_torch.models.vqa_ef import ef_img_encode
from lctvqa_torch.ops import cuda_lstm
from lctvqa_torch.ops import nn as N
from lctvqa_torch.ops.cuda_lstm import cell_weights
from lctvqa_torch.ops.losses import sequence_teacher_forcing_ce
from lctvqa_torch.ops.lstm import lstm, lstm_init


def check_arch_type(arch_type: str) -> None:
    if arch_type not in ("darts", "fixed"):
        raise ValueError(f"the unified model's image encoder is 'darts' "
                         f"(the supernet) or 'fixed' (VGG19), not "
                         f"{arch_type!r}")


def init_unified_model(gen: torch.Generator, cfg: ModelConfig,
                       vgg_params=None):
    """-> (params, arch); arch is None for the VGG19 encoder."""
    check_arch_type(cfg.arch_type)
    params, arch = {}, None
    if cfg.arch_type == "darts":
        params["darts"] = search.network_init(gen, cfg)
        in_features = search.network_out_features(cfg)
        arch = search.arch_init(gen, cfg)
    else:
        params["vgg"] = (vgg_params if vgg_params is not None else
                         vgg.vgg19_init(gen, cfg.vgg_width_mult,
                                        cfg.vgg_fc_dim))
        in_features = vgg.feature_dim(params["vgg"])
    params["img_fc"] = N.torch_linear_init(gen, in_features,
                                           cfg.img_embed_size)
    params["qa"] = {
        "word2vec": N.embedding_init(gen, cfg.qst_vocab_size,
                                     cfg.word_embed_size),
        "lstm": lstm_init(gen, cfg.word_embed_size, cfg.lstm_hidden_size,
                          cfg.lstm_num_layers),
        "fc2": N.xavier_linear_init(gen, cfg.lstm_hidden_size,
                                    cfg.qst_vocab_size),
    }
    return params, arch


def _img_encode(params, arch, cfg: ModelConfig, img, gen, deterministic):
    check_arch_type(cfg.arch_type)
    return ef_img_encode(params, arch, cfg, img, gen, deterministic)


def unified_forward(params, arch, cfg: ModelConfig, img: torch.Tensor,
                    qa_str: torch.Tensor,
                    gen: Optional[torch.Generator] = None,
                    deterministic: bool = True) -> torch.Tensor:
    """-> next-token logits [B, T, V], teacher forced."""
    dt = N.torch_dtype(cfg.compute_dtype)
    img_feature = _img_encode(params, arch, cfg, img, gen, deterministic)
    b = qa_str.shape[0]
    x = torch.tanh(N.embed(params["qa"]["word2vec"], qa_str))
    layers = params["qa"]["lstm"]["layers"]
    if cfg.pallas_seq_lstm and len(layers) == 1:
        h0 = img_feature.reshape(b, -1)
        outs, _ = cuda_lstm.lstm_seq(cell_weights(layers[0], dt), x, h0, h0)
    else:
        h0 = img_feature.reshape(1, b, -1)
        outs, _ = lstm(params["qa"]["lstm"], x, h0=h0, c0=h0, dtype=dt,
                       use_kernel=cfg.use_pallas_lstm)
    return N.linear(params["qa"]["fc2"], torch.tanh(outs), dtype=dt)


def unified_generate(params, arch, cfg: ModelConfig, img: torch.Tensor,
                     gen: Optional[torch.Generator] = None,
                     deterministic: bool = True,
                     sample_deterministic: bool = True,
                     sample_gen: Optional[torch.Generator] = None,
                     temperature: float = 0.1) -> torch.Tensor:
    """The `<start> q <sep> a <end>` stream, int32 [B, T], greedy or
    sampled as `qst_encoder.ef_qst_generate` decodes."""
    img_feature = _img_encode(params, arch, cfg, img, gen, deterministic)
    return ef_qst_generate(params["qa"], img_feature, cfg.max_qst_len,
                           dtype=N.torch_dtype(cfg.compute_dtype),
                           use_kernel=cfg.use_pallas_lstm,
                           use_generate_kernel=cfg.pallas_generate,
                           deterministic=sample_deterministic,
                           sample_gen=sample_gen, temperature=temperature)


def unified_loss(params, arch, cfg: ModelConfig, img, qa_str,
                 gen: Optional[torch.Generator] = None,
                 deterministic: bool = True) -> torch.Tensor:
    """Shifted next-token CE over the whole stream."""
    return sequence_teacher_forcing_ce(
        unified_forward(params, arch, cfg, img, qa_str, gen, deterministic),
        qa_str)
