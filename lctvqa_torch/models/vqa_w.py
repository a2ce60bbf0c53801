"""W model, the baseline VQA learner (port of lctvqa/models/vqa_w.py).

VGG19 image feature -> fc -> L2 normalize; W-style question encoder;
elementwise-mul fusion -> tanh -> dropout -> fc1 -> tanh -> dropout -> fc2.
Forward only: training is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from lctvqa_torch.config import ModelConfig
from lctvqa_torch.models import vgg
from lctvqa_torch.models.qst_encoder import w_qst_encoder, w_qst_encoder_init
from lctvqa_torch.ops import nn as N


def init_w_model(gen: torch.Generator, cfg: ModelConfig, vgg_params=None):
    if vgg_params is None:
        vgg_params = vgg.vgg19_init(gen, cfg.vgg_width_mult, cfg.vgg_fc_dim)
    return {
        "vgg": vgg_params,
        "img_fc": N.torch_linear_init(gen, vgg.feature_dim(vgg_params),
                                      cfg.img_embed_size),
        "qst": w_qst_encoder_init(gen, cfg.qst_vocab_size,
                                  cfg.word_embed_size, cfg.img_embed_size,
                                  cfg.lstm_num_layers, cfg.lstm_hidden_size),
        "fc1": N.torch_linear_init(gen, cfg.img_embed_size,
                                   cfg.ans_vocab_size),
        "fc2": N.torch_linear_init(gen, cfg.ans_vocab_size,
                                   cfg.ans_vocab_size),
    }


def w_forward(params, cfg: ModelConfig, img: torch.Tensor, qst: torch.Tensor,
              gen: Optional[torch.Generator] = None,
              deterministic: bool = True) -> torch.Tensor:
    """img NHWC fp32 normalized, qst int [B, T] -> answer logits [B, A]."""
    dt = N.torch_dtype(cfg.compute_dtype)
    feat = vgg.vgg19_features(params["vgg"], img, gen=gen,
                              deterministic=deterministic, dtype=dt)
    img_feature = N.l2_normalize(N.linear(params["img_fc"], feat, dtype=dt))
    qst_feature = w_qst_encoder(params["qst"], qst, dtype=dt,
                                use_kernel=cfg.use_pallas_lstm,
                                use_seq_kernel=cfg.pallas_seq_lstm)
    x = torch.tanh(img_feature * qst_feature)
    x = N.dropout(x, cfg.dropout_rate, gen, deterministic)
    x = torch.tanh(N.linear(params["fc1"], x, dtype=dt))
    x = N.dropout(x, cfg.dropout_rate, gen, deterministic)
    return N.linear(params["fc2"], x, dtype=dt)
