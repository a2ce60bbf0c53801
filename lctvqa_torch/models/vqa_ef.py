"""EF model, the question-generating "test-creator" (port of
lctvqa/models/vqa_ef.py). The image encoder is the PC-DARTS search
network (`arch_type="darts"`, with its arch parameters in `arch`) or
VGG19 (`arch_type="fixed"`, `arch` None).

Derived nets (`arch_type="derived"`) are not ported yet (ROADMAP.md,
queue 1, "Derived"), and asking for them raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lctvqa_torch.config import ModelConfig
from lctvqa_torch.models import search, vgg
from lctvqa_torch.models.qst_encoder import (ef_qst_encoder,
                                             ef_qst_encoder_init,
                                             ef_qst_generate)
from lctvqa_torch.ops import nn as N


def check_arch_type(arch_type: str) -> None:
    if arch_type not in ("fixed", "darts"):
        raise NotImplementedError(
            f"EF arch_type={arch_type!r} is not ported yet: derived nets "
            "come with models/derived.py (ROADMAP.md, queue 1, 'Derived'); "
            "arch_type='darts' (the supernet) and 'fixed' (VGG19) run")


def init_ef_model(gen: torch.Generator, cfg: ModelConfig, vgg_params=None):
    """Returns (params, arch); arch is None for arch_type='fixed'."""
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
    params["qst"] = ef_qst_encoder_init(
        gen, cfg.qst_vocab_size, cfg.word_embed_size, cfg.img_embed_size,
        cfg.lstm_num_layers, cfg.lstm_hidden_size)
    params["fc1"] = N.torch_linear_init(gen, cfg.img_embed_size,
                                        cfg.ans_vocab_size)
    params["fc2"] = N.torch_linear_init(gen, cfg.ans_vocab_size,
                                        cfg.ans_vocab_size)
    return params, arch


def ef_img_encode(params, arch, cfg: ModelConfig, img: torch.Tensor,
                  gen: Optional[torch.Generator] = None,
                  deterministic: bool = True) -> torch.Tensor:
    """Image -> L2-normalized embed_size feature."""
    check_arch_type(cfg.arch_type)
    dt = N.torch_dtype(cfg.compute_dtype)
    if cfg.arch_type == "darts":
        if cfg.fuse_mixed_ops:
            raise NotImplementedError(
                "fuse_mixed_ops (search_fused.py) is a JAX-only way of "
                "running the supernet and is not ported (ROADMAP.md, 'Not "
                "ported')")
        feat = search.network_apply(params["darts"], arch, cfg, img, dtype=dt)
    else:
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
