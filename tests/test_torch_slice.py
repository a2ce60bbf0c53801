"""The port's serving slice against the JAX package, on the CPU in fp32.

Params come from the JAX package's own init (`init_w_model`,
`init_ef_model`, fixed VGG19 encoder), go through
`lctvqa_torch.convert`, and both packages run the same seeded numpy
inputs with dropout off. Tolerance 1e-4, that of
tests/test_full_model_torch_parity.py; greedy tokens exact. Each model
runs twice: with the default kernel flags and with the sequence and
decode kernels on, which on the CPU route through the kernels' plain
versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lctvqa.config import small_test_config
from lctvqa.models import vqa_ef, vqa_w
from lctvqa_torch import convert
from lctvqa_torch.data.pipeline import normalize_images
from lctvqa_torch.models import vgg as t_vgg
from lctvqa_torch.models import vqa_ef as t_ef
from lctvqa_torch.models import vqa_w as t_w

TOL = 1e-4
MCFG = dataclasses.replace(small_test_config().model, arch_type="fixed",
                           img_size=32, compute_dtype="float32")
FLAGS = {"default": {},
         "kernels": {"pallas_seq_lstm": True, "pallas_generate": True}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (3, MCFG.img_size, MCFG.img_size, 3),
                      dtype=np.uint8)
    qst = rng.integers(0, MCFG.qst_vocab_size, (3, MCFG.max_qst_len),
                       dtype=np.int32)
    from lctvqa.data.pipeline import normalize_images as jax_normalize
    img = np.array(jax_normalize(jnp.asarray(u8)))  # writable copy
    return u8, img, qst


@pytest.fixture(scope="module")
def w_params():
    return _np_tree(vqa_w.init_w_model(jax.random.PRNGKey(0), MCFG))


@pytest.fixture(scope="module")
def ef_params():
    params, arch = vqa_ef.init_ef_model(jax.random.PRNGKey(1), MCFG)
    assert arch is None
    return _np_tree(params)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_normalize_images_matches(inputs):
    u8, img, _ = inputs
    np.testing.assert_array_equal(
        normalize_images(torch.from_numpy(u8)).numpy(), img)


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_w_logits_match(w_params, inputs, flags):
    _, img, qst = inputs
    want = vqa_w.w_forward(w_params, MCFG, jnp.asarray(img), jnp.asarray(qst))
    cfg = dataclasses.replace(MCFG, **FLAGS[flags])
    got = t_w.w_forward(convert.from_jax(w_params), cfg,
                        torch.from_numpy(img), torch.from_numpy(qst))
    _close(got, want)


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_ef_logits_and_generate_match(ef_params, inputs, flags):
    _, img, qst = inputs
    cfg = dataclasses.replace(MCFG, **FLAGS[flags])
    params = convert.from_jax(ef_params)
    want_ans, want_qst = vqa_ef.ef_forward(ef_params, None, MCFG,
                                           jnp.asarray(img), jnp.asarray(qst))
    got_ans, got_qst = t_ef.ef_forward(params, None, cfg,
                                       torch.from_numpy(img),
                                       torch.from_numpy(qst))
    _close(got_ans, want_ans)
    _close(got_qst, want_qst)

    want_tok, want_gen = vqa_ef.ef_generate(ef_params, None, MCFG,
                                            jnp.asarray(img))
    got_tok, got_gen = t_ef.ef_generate(params, None, cfg,
                                        torch.from_numpy(img))
    assert got_tok.dtype == torch.int32
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    _close(got_gen, want_gen)


@pytest.mark.parametrize("family", ["w", "ef"])
def test_convert_round_trip_is_exact(w_params, ef_params, family):
    tree = w_params if family == "w" else ef_params
    back = convert.to_jax(convert.from_jax(tree))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    conv = convert.from_jax(tree)["vgg"]["features"][0]["w"]
    assert conv.shape == (tree["vgg"]["features"][0]["w"].shape[3], 3, 3, 3)


def test_torchvision_state_dict_loads_as_is(w_params):
    """A torchvision-keyed VGG19 state_dict (OIHW convs, [out, in]
    linears) loads into the port's layout, the same params the JAX
    package's converter builds from it."""
    from lctvqa.models import vgg as jax_vgg

    port = convert.from_jax(w_params["vgg"])
    sd, layer = {}, 0
    for v in jax_vgg.VGG19_CFG:
        if v == "M":
            layer += 1
            continue
        conv = port["features"][len(sd) // 2]
        sd[f"features.{layer}.weight"] = conv["w"]
        sd[f"features.{layer}.bias"] = conv["b"]
        layer += 2
    for name, key in (("fc6", "classifier.0"), ("fc7", "classifier.3")):
        sd[f"{key}.weight"] = port[name]["w"].t()
        sd[f"{key}.bias"] = port[name]["b"]
    got = t_vgg.convert_torch_state_dict(sd)
    want = convert.from_jax(_np_tree(jax_vgg.convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()})))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)


def test_ef_other_encoders_raise():
    with pytest.raises(NotImplementedError, match="derived"):
        t_ef.init_ef_model(torch.Generator().manual_seed(0),
                           dataclasses.replace(MCFG, arch_type="derived"))
