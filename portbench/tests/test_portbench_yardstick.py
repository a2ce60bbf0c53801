"""The yardstick's frozen arithmetic agrees with what it was copied from:
the model FLOPs with the JAX package's `lctvqa/ops/flops.py` at small
configurations (this test alone imports both), VGG19's convolutions at
224 px with the published 39.0 GFLOP a pair, and the roofline bounds with
`chip_smoke.py`'s at its kernel phases' shapes."""

from __future__ import annotations

import dataclasses

import pytest

import chip_smoke
from lctvqa.config import ModelConfig as JaxModelConfig
from lctvqa.ops import flops as jax_flops
from portbench import flops, roofline

SMALL = [dict(img_size=32, img_embed_size=32, word_embed_size=16,
              lstm_hidden_size=32, max_qst_len=8, qst_vocab_size=64,
              ans_vocab_size=16, darts_init_ch=4, darts_layers=2,
              vgg_width_mult=0.125, vgg_fc_dim=64),
         dict(img_size=64, darts_layers=4),
         dict(img_size=224)]


@pytest.mark.parametrize("sizes", SMALL)
def test_model_flops_agree_with_the_jax_package(sizes):
    cfg = dataclasses.replace(JaxModelConfig(), **sizes)
    m = dataclasses.asdict(cfg)
    for n in (1, 8, 64):
        assert flops.darts_fwd_flops(m, n) == jax_flops.darts_fwd_flops(cfg,
                                                                        n)
        assert flops.w_fwd_flops(m, n) == jax_flops.w_fwd_flops(cfg, n)
        assert flops.ef_fwd_flops(m, n) == jax_flops.ef_fwd_flops(cfg, n)
        assert flops.ef_generate_flops(m, n) == \
            jax_flops.ef_generate_flops(cfg, n)


def test_vgg19_convolutions_at_224_px_are_39_gflop():
    assert flops.vgg19_conv_flops(1, 224) / 1e9 == pytest.approx(39.0,
                                                                 abs=0.05)


@pytest.mark.parametrize("dname", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", chip_smoke.BATCHES)
def test_rooflines_agree_with_chip_smoke(n, dname):
    for h, w, c, edges in chip_smoke.NODE_SHAPES.values():
        cs = c // 4
        for e in edges:
            assert roofline.node_fwd(n, h, w, cs, e, dname) == \
                pytest.approx(chip_smoke.node_bound(n, h, w, cs, e,
                                                    dname)[0] * 1e-3)
            assert roofline.node_bwd(n, h, w, cs, e, dname) == \
                pytest.approx(chip_smoke.node_bwd_bound(n, h, w, cs, e,
                                                        dname)[0] * 1e-3)
    for shape in chip_smoke.BN_SHAPES:
        numel = shape[0] * shape[1] * shape[2] * shape[3]
        size = 2 if dname == "bfloat16" else 4
        assert roofline.bn_fwd(numel, dname, "float32") == pytest.approx(
            chip_smoke.bound(numel * (size + 4), 5 * numel,
                             "float32")[0] * 1e-3)
        assert roofline.bn_bwd(numel, dname, "float32") == pytest.approx(
            chip_smoke.bound(numel * (2 * size + 4), 10 * numel,
                             "float32")[0] * 1e-3)
    mcfg = chip_smoke.model_configs()["darts"]
    want = chip_smoke.lstm_bounds(mcfg, n, dname)["greedy_generate"][0]
    got = roofline.greedy_generate(n, mcfg.word_embed_size,
                                   mcfg.lstm_hidden_size, mcfg.max_qst_len,
                                   mcfg.qst_vocab_size, dname)
    assert got == pytest.approx(want * 1e-3)
