"""EF model, the question-generating "test-creator" (port of
lctvqa/models/vqa_ef.py). The image encoder is the PC-DARTS search
network (`arch_type="darts"`, with its arch parameters in `arch`; its
edge-batched form, models/search_fused.py, with `fuse_mixed_ops`), a
derived network built from `cfg.genotype` (`arch_type="derived"`,
models/derived.py) or VGG19 (`arch_type="fixed"`); `arch` is None for
the last two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lctvqa_torch.config import ModelConfig
from lctvqa_torch.models import derived, search, search_fused, vgg
from lctvqa_torch.models.qst_encoder import (ef_qst_encoder,
                                             ef_qst_encoder_init,
                                             ef_qst_generate)
from lctvqa_torch.ops import nn as N
from lctvqa_torch.ops.losses import (cross_entropy,
                                     sequence_teacher_forcing_ce)


def check_arch_type(arch_type: str, genotype=None) -> None:
    if arch_type not in ("fixed", "darts", "derived"):
        raise ValueError(f"unknown EF arch_type {arch_type!r}: 'darts' (the "
                         "supernet), 'derived' or 'fixed' (VGG19)")
    if arch_type == "derived" and genotype is None:
        raise ValueError("arch_type='derived' needs genotype (--genotype: a "
                         "preset, a search checkpoint or a repr file)")


def init_ef_model(gen: torch.Generator, cfg: ModelConfig, vgg_params=None):
    """Returns (params, arch); arch is None for arch_type='fixed'."""
    check_arch_type(cfg.arch_type, cfg.genotype)
    params, arch = {}, None
    if cfg.arch_type == "darts":
        params["darts"] = search.network_init(gen, cfg)
        in_features = search.network_out_features(cfg)
        arch = search.arch_init(gen, cfg)
    elif cfg.arch_type == "derived":
        params["derived"] = derived.derived_network_init(gen, cfg,
                                                         cfg.genotype)
        in_features = derived.derived_out_features(cfg, cfg.genotype)
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
    check_arch_type(cfg.arch_type, cfg.genotype)
    dt = N.torch_dtype(cfg.compute_dtype)
    if cfg.arch_type == "darts":
        # the edge-batched cell first, ahead of the node kernel, as in the
        # JAX package
        net = (search_fused.network_apply_fused if cfg.fuse_mixed_ops
               else search.network_apply)
        feat = net(params["darts"], arch, cfg, img, dtype=dt)
    elif cfg.arch_type == "derived":
        feat = derived.derived_network_apply(params["derived"], cfg,
                                             cfg.genotype, img, dtype=dt)
    else:
        vgg_params = params["vgg"]
        if cfg.pretrained_enc:  # frozen iff pretrained
            vgg_params = N.detach_tree(vgg_params)
        feat = vgg.vgg19_features(vgg_params, img, gen=gen,
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
               deterministic: bool = True,
               img_feature: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (answer logits [B, A], question logits [B, T, V]).
    `img_feature`: `ef_img_encode`'s of `img`, where the caller has it."""
    dt = N.torch_dtype(cfg.compute_dtype)
    if img_feature is None:
        img_feature = ef_img_encode(params, arch, cfg, img, gen,
                                    deterministic)
    qst_feature, qst_logits = ef_qst_encoder(
        params["qst"], qst, img_feature, dtype=dt,
        use_kernel=cfg.use_pallas_lstm, use_seq_kernel=cfg.pallas_seq_lstm)
    ans = _answer_head(params, cfg, img_feature, qst_feature, gen,
                       deterministic)
    return ans, qst_logits


def ef_generate(params, arch, cfg: ModelConfig, img: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                deterministic: bool = True,
                sample_deterministic: bool = True,
                sample_gen: Optional[torch.Generator] = None,
                temperature: float = 0.1,
                img_feature: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate a question, then answer it. `deterministic` gates dropout
    (training generates with dropout on); `sample_deterministic` picks the
    greedy token or a sample at `temperature` from `sample_gen`;
    `img_feature` as in `ef_forward`.
    Returns (question int32 [B, T], answer logits [B, A])."""
    dt = N.torch_dtype(cfg.compute_dtype)
    if img_feature is None:
        img_feature = ef_img_encode(params, arch, cfg, img, gen,
                                    deterministic)
    qst = ef_qst_generate(params["qst"], img_feature, cfg.max_qst_len,
                          dtype=dt, use_kernel=cfg.use_pallas_lstm,
                          use_generate_kernel=cfg.pallas_generate,
                          deterministic=sample_deterministic,
                          sample_gen=sample_gen, temperature=temperature)
    qst_feature, _ = ef_qst_encoder(params["qst"], qst, img_feature, dtype=dt,
                                    use_kernel=cfg.use_pallas_lstm,
                                    use_seq_kernel=cfg.pallas_seq_lstm)
    ans = _answer_head(params, cfg, img_feature, qst_feature, gen,
                       deterministic)
    return qst, ans


def ef_loss(params, arch, cfg: ModelConfig, img, qst, labels,
            gen: Optional[torch.Generator] = None,
            deterministic: bool = True,
            qst_only: bool = False) -> torch.Tensor:
    """Answer CE + shifted teacher-forcing question CE; `qst_only` drops
    the answer term."""
    ans_logits, qst_logits = ef_forward(params, arch, cfg, img, qst, gen,
                                        deterministic)
    qst_ce = sequence_teacher_forcing_ce(qst_logits, qst)
    if qst_only:
        return qst_ce
    return cross_entropy(ans_logits, labels) + qst_ce
