"""EF model, the question-generating "test-creator" (port of
lctvqa/models/vqa_ef.py) with the fixed VGG19 image encoder
(`arch_type="fixed"`).

The PC-DARTS supernet (`arch_type="darts"`) and derived nets
(`"derived"`) are not ported yet: they come with the later slice that
ports the supernet and its kernels (ROADMAP.md, queue 1 items 2 and 4),
and asking for them raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lctvqa.config import ModelConfig
from lctvqa_torch.models import vgg
from lctvqa_torch.models.qst_encoder import (ef_qst_encoder,
                                             ef_qst_encoder_init,
                                             ef_qst_generate)
from lctvqa_torch.ops import nn as N


def check_fixed(arch_type: str) -> None:
    if arch_type != "fixed":
        raise NotImplementedError(
            f"EF arch_type={arch_type!r} is not ported yet: the PC-DARTS "
            "supernet and derived nets come with the later port slice for "
            "the supernet and its kernels 5-7 (ROADMAP.md, queue 1 items 2 "
            "and 4); only arch_type='fixed' (VGG19) runs")


def init_ef_model(gen: torch.Generator, cfg: ModelConfig, vgg_params=None):
    """Returns (params, arch); arch is None for arch_type='fixed'."""
    check_fixed(cfg.arch_type)
    params = {"vgg": vgg_params if vgg_params is not None
              else vgg.vgg19_init(gen, cfg.vgg_width_mult, cfg.vgg_fc_dim)}
    params["img_fc"] = N.torch_linear_init(gen, vgg.feature_dim(params["vgg"]),
                                           cfg.img_embed_size)
    params["qst"] = ef_qst_encoder_init(
        gen, cfg.qst_vocab_size, cfg.word_embed_size, cfg.img_embed_size,
        cfg.lstm_num_layers, cfg.lstm_hidden_size)
    params["fc1"] = N.torch_linear_init(gen, cfg.img_embed_size,
                                        cfg.ans_vocab_size)
    params["fc2"] = N.torch_linear_init(gen, cfg.ans_vocab_size,
                                        cfg.ans_vocab_size)
    return params, None


def ef_img_encode(params, arch, cfg: ModelConfig, img: torch.Tensor,
                  gen: Optional[torch.Generator] = None,
                  deterministic: bool = True) -> torch.Tensor:
    """Image -> L2-normalized embed_size feature."""
    check_fixed(cfg.arch_type)
    dt = N.torch_dtype(cfg.compute_dtype)
    feat = vgg.vgg19_features(params["vgg"], img, gen=gen,
                              deterministic=deterministic, dtype=dt)
    return N.l2_normalize(N.linear(params["img_fc"], feat, dtype=dt))


def _answer_head(params, cfg: ModelConfig, img_feature, qst_feature, gen,
                 deterministic):
    dt = N.torch_dtype(cfg.compute_dtype)
    x = torch.tanh(img_feature * qst_feature)
    x = N.dropout(x, cfg.dropout_rate, gen, deterministic)
    x = torch.tanh(N.linear(params["fc1"], x, dtype=dt))
    x = N.dropout(x, cfg.dropout_rate, gen, deterministic)
    return N.linear(params["fc2"], x, dtype=dt)


def ef_forward(params, arch, cfg: ModelConfig, img: torch.Tensor,
               qst: torch.Tensor, gen: Optional[torch.Generator] = None,
               deterministic: bool = True) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """-> (answer logits [B, A], question logits [B, T, V])."""
    dt = N.torch_dtype(cfg.compute_dtype)
    img_feature = ef_img_encode(params, arch, cfg, img, gen, deterministic)
    qst_feature, qst_logits = ef_qst_encoder(
        params["qst"], qst, img_feature, dtype=dt,
        use_kernel=cfg.use_pallas_lstm, use_seq_kernel=cfg.pallas_seq_lstm)
    ans = _answer_head(params, cfg, img_feature, qst_feature, gen,
                       deterministic)
    return ans, qst_logits


def ef_generate(params, arch, cfg: ModelConfig, img: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                deterministic: bool = True) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Greedily generate a question, then answer it.
    Returns (question int32 [B, T], answer logits [B, A])."""
    dt = N.torch_dtype(cfg.compute_dtype)
    img_feature = ef_img_encode(params, arch, cfg, img, gen, deterministic)
    qst = ef_qst_generate(params["qst"], img_feature, cfg.max_qst_len,
                          dtype=dt, use_kernel=cfg.use_pallas_lstm,
                          use_generate_kernel=cfg.pallas_generate)
    qst_feature, _ = ef_qst_encoder(params["qst"], qst, img_feature, dtype=dt,
                                    use_kernel=cfg.use_pallas_lstm,
                                    use_seq_kernel=cfg.pallas_seq_lstm)
    ans = _answer_head(params, cfg, img_feature, qst_feature, gen,
                       deterministic)
    return qst, ans
