"""The derived network (lctvqa_torch/models/derived.py), the derived EF
and a served derived-EF artifact against the JAX package on the CPU, in
fp32 at `small_test_config` dims with a derived trunk of three cells
(darts_init_ch 4, darts_layers 3: a normal cell, a reduction cell and a
reduction cell after a reduction, whose preprocess is the factorized
one), 16-pixel images, batch 4.

Parameters are the JAX package's init, carried across with
`convert.from_jax`; inputs are numpy draws from a seed. Tolerance 1e-4
(tests/test_full_model_torch_parity.py): outputs and losses within 1e-4
absolute and relative, each gradient leaf within 1e-4 of its own scale
plus 1e-6 of the largest leaf's (for leaves whose exact gradient is 0);
greedy tokens and argmaxes exact. The JAX references are compiled with
LLVM's optimizations off (tests/test_torch_architect.py's jax_compiled).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lctvqa import __version__
from lctvqa.config import small_test_config as j_small_config
from lctvqa.export import save_artifact
from lctvqa.models import derived as j_derived, genotypes as j_genotypes
from lctvqa.models import vqa_ef as j_ef
from lctvqa.ops import conv as j_conv
from lctvqa_torch import convert
from lctvqa_torch.config import small_test_config
from lctvqa_torch.export import load_artifact
from lctvqa_torch.models import derived, genotypes, vqa_ef
from lctvqa_torch.ops import conv as t_conv
from lctvqa_torch.optim.optimizers import tree_leaves
from lctvqa_torch.train.steps import with_grad
from test_torch_architect import jax_compiled
from test_torch_train import (_assert_leaves_close, _grads_to_jax,
                              one_cpu_thread)  # noqa: F401 (autouse)

B = 4
TOL = 1e-4
FLOOR = 1e-6
GENOTYPES = ("PC_DARTS_cifar", "AmoebaNet")
DERIVED = dict(arch_type="derived", darts_init_ch=4, darts_layers=3,
               img_size=16, compute_dtype="float32")


def _grads_close(tp, grads, want_g):
    """Each gradient leaf within TOL of its own scale, plus FLOOR of the
    largest leaf's: a bias whose shift a later affine-free BatchNorm
    cancels (through an avg pool, say) has an exact gradient of 0, and
    both packages give rounding residue there."""
    top = max(float(np.abs(np.asarray(g)).max())
              for g in jax.tree_util.tree_leaves(want_g))
    _assert_leaves_close(_grads_to_jax(tp, grads), want_g, TOL, FLOOR * top)


def _cfgs(name="PC_DARTS_cifar", **kw):
    """(JAX model config, port model config) of the derived EF of the preset
    `name`, its cell shape the genotype's."""
    out = []
    for make, presets in ((j_small_config, j_genotypes),
                          (small_test_config, genotypes)):
        g = getattr(presets, name)
        out.append(dataclasses.replace(
            make().model, genotype=g, darts_steps=len(g.normal) // 2,
            darts_multiplier=len(g.normal_concat), **{**DERIVED, **kw}))
    return out


def _image(seed=0, b=B, size=16):
    """Float images from a seed: no two values tie in a max pool."""
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def _qa(mcfg, seed=1, b=B):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, mcfg.qst_vocab_size, (b, mcfg.max_qst_len))
            .astype(np.int32),
            rng.integers(0, mcfg.ans_vocab_size, b).astype(np.int32))


@pytest.mark.parametrize("name", GENOTYPES)
def test_derived_trunk_matches_jax(name):
    """The trunk's features and the gradient of a fixed projection of them
    w.r.t. every parameter. AmoebaNet has 5 nodes a cell, other concat
    widths for its two cell types, a node reading node 3 and the 1x7/7x1
    convolutions."""
    jm, tm = _cfgs(name)
    params = j_derived.derived_network_init(jax.random.PRNGKey(3), jm,
                                            jm.genotype)
    x = _image()
    n_out = derived.derived_out_features(tm, tm.genotype)
    r = np.random.default_rng(4).standard_normal((B, n_out)).astype(
        np.float32)

    def j_loss(p):
        out = j_derived.derived_network_apply(p, jm, jm.genotype,
                                              jnp.asarray(x))
        return jnp.sum(out * r), out

    (_, want), want_g = jax_compiled(
        jax.value_and_grad(j_loss, has_aux=True), params)
    tp = with_grad(convert.from_jax(params))
    out = derived.derived_network_apply(tp, tm, tm.genotype,
                                        torch.from_numpy(x))
    assert out.shape == (B, n_out) == want.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                tree_leaves(tp))
    _grads_close(tp, grads, want_g)
    # the port's own init builds the JAX package's tree
    mine = derived.derived_network_init(torch.Generator().manual_seed(0), tm,
                                        tm.genotype)
    assert (jax.tree_util.tree_structure(convert.to_jax(mine))
            == jax.tree_util.tree_structure(params))
    assert [a.shape for a in jax.tree_util.tree_leaves(convert.to_jax(mine))] \
        == [a.shape for a in jax.tree_util.tree_leaves(params)]


def test_derived_ef_loss_grads_and_greedy_tokens_match_jax():
    """ef_loss (answer CE + teacher-forced question CE) and its gradient
    w.r.t. every EF leaf; the greedy questions and answer logits of
    ef_generate, tokens exact."""
    jm, tm = _cfgs()
    params, arch = j_ef.init_ef_model(jax.random.PRNGKey(5), jm)
    assert arch is None
    img = _image(seed=6)
    qst, labels = _qa(jm)

    def j_loss(p):
        return j_ef.ef_loss(p, None, jm, jnp.asarray(img), jnp.asarray(qst),
                            jnp.asarray(labels), deterministic=True)

    want, want_g = jax_compiled(jax.value_and_grad(j_loss), params)
    tp = with_grad(convert.from_jax(params))
    got = vqa_ef.ef_loss(tp, None, tm, torch.from_numpy(img),
                         torch.from_numpy(qst), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL,
                               atol=TOL)
    grads = torch.autograd.grad(got, tree_leaves(tp))
    _grads_close(tp, grads, want_g)

    j_tok, j_ans = jax_compiled(
        lambda p, x: j_ef.ef_generate(p, None, jm, x), params,
        jnp.asarray(img))
    with torch.no_grad():
        tok, ans = vqa_ef.ef_generate(convert.from_jax(params), None, tm,
                                      torch.from_numpy(img))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    np.testing.assert_allclose(ans.numpy(), np.asarray(j_ans), rtol=TOL,
                               atol=TOL)


def test_derived_trunk_bn_eval_stats_capture_and_eval_order():
    """With running statistics (--bn_eval_stats) every BatchNorm of the
    trunk, affine and affine-free, is one entry in call order: the
    captured batch statistics equal the JAX package's entry by entry, and
    the trunk evaluated on them (consuming every entry) matches."""
    jm, tm = _cfgs(bn_eval_stats=True)
    params = j_derived.derived_network_init(jax.random.PRNGKey(7), jm,
                                            jm.genotype)
    tp = convert.from_jax(params)
    x, x_eval = _image(seed=8), _image(seed=9)
    with j_conv.bn_capture() as j_cap:
        j_derived.derived_network_apply(params, jm, jm.genotype,
                                        jnp.asarray(x))
    with t_conv.bn_capture() as cap:
        derived.derived_network_apply(tp, tm, tm.genotype,
                                      torch.from_numpy(x))
    assert len(cap.stats) == len(j_cap.stats) > 20
    for ours, theirs in zip(cap.stats, j_cap.stats):
        for k in ("mean", "var"):
            assert ours[k].shape == theirs[k].shape
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                       rtol=TOL, atol=TOL)
    running = t_conv.update_running_stats(
        t_conv.init_running_stats(cap.stats), cap.stats)
    j_running = j_conv.update_running_stats(
        j_conv.init_running_stats(j_cap.stats), j_cap.stats)
    with j_conv.bn_eval(j_running):
        want = j_derived.derived_network_apply(params, jm, jm.genotype,
                                               jnp.asarray(x_eval))
    with t_conv.bn_eval(running):
        got = derived.derived_network_apply(tp, tm, tm.genotype,
                                            torch.from_numpy(x_eval))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    with pytest.raises(ValueError, match="consumed"):
        with t_conv.bn_eval(running + running[:1]):
            derived.derived_network_apply(tp, tm, tm.genotype,
                                          torch.from_numpy(x_eval))


def test_convert_maps_amoebanet_1x7_and_7x1_convs():
    """No rule of its own: HWIO <-> OIHW covers the derived tree, the 1x7
    and 7x1 convolutions of AmoebaNet's conv_7x1_1x7 included, exactly
    and both ways."""
    jm, _ = _cfgs("AmoebaNet")
    params = jax.tree_util.tree_map(np.asarray, j_derived.derived_network_init(
        jax.random.PRNGKey(10), jm, jm.genotype))
    reduce_cell = params["cells"][1]
    j = [n for n, _ in jm.genotype.reduce].index("conv_7x1_1x7")
    op = reduce_cell["ops"][j]
    assert op["conv_1x7"]["w"].shape == (1, 7, 8, 8)
    port = convert.from_jax(params)
    assert port["cells"][1]["ops"][j]["conv_1x7"]["w"].shape == (8, 8, 1, 7)
    assert port["cells"][1]["ops"][j]["conv_7x1"]["w"].shape == (8, 8, 7, 1)
    np.testing.assert_array_equal(
        port["cells"][1]["ops"][j]["conv_1x7"]["w"].numpy(),
        op["conv_1x7"]["w"].transpose(3, 2, 0, 1))
    for a, b in zip(jax.tree_util.tree_leaves(convert.to_jax(port)),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# a served derived-EF artifact
# ---------------------------------------------------------------------------

def _artifact(tmp_path, params, mcfg):
    """A derived-EF artifact as lctvqa.export writes one: params in the JAX
    layout, meta with arch_type 'derived' and no genotype."""
    meta = {"artifact_version": 1, "family": "ef", "int8": False,
            "platforms": ["cpu"], "img_size": mcfg.img_size,
            "max_qst_len": mcfg.max_qst_len,
            "qst_vocab_size": mcfg.qst_vocab_size,
            "ans_vocab_size": mcfg.ans_vocab_size, "arch_type": "derived",
            "epoch": 1, "lctvqa_version": __version__}
    path = str(tmp_path / "derived.lctx")
    save_artifact({"exported": {}, "meta": meta, "params": {
        "params": jax.tree_util.tree_map(np.asarray, params)}}, path)
    return path


def test_served_derived_artifact_matches_jax(tmp_path):
    """ServingModel over a derived-EF artifact, its genotype given by name:
    answer logits against the JAX package's ef_forward, greedy questions
    and answers against its ef_generate; a genotype given as a
    Genotype-repr file serves the same. Without a genotype it raises and
    names the flag; a genotype of another network raises."""
    jm, _ = _cfgs()
    params, _ = j_ef.init_ef_model(jax.random.PRNGKey(11), jm)
    path = _artifact(tmp_path, params, jm)
    rng = np.random.default_rng(12)
    u8 = rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8)
    qst, _ = _qa(jm, seed=13)
    img = (u8.astype(np.float32) / 255.0 - np.array(
        [0.485, 0.456, 0.406], np.float32)) / np.array(
        [0.229, 0.224, 0.225], np.float32)

    want, _ = jax_compiled(
        lambda p, x, q: j_ef.ef_forward(p, None, jm, x, q), params,
        jnp.asarray(img), jnp.asarray(qst))
    j_tok, j_ans = jax_compiled(
        lambda p, x: j_ef.ef_generate(p, None, jm, x), params,
        jnp.asarray(img))
    model = load_artifact(path, device="cpu", genotype="PC_DARTS_cifar",
                          compute_dtype="float32")
    assert model.config.arch_type == "derived"
    assert model.config.darts_layers == 3 and model.config.darts_init_ch == 4
    np.testing.assert_allclose(model.answer_logits(u8, qst).numpy(),
                               np.asarray(want), rtol=TOL, atol=TOL)
    tok, ans = model.generate(u8)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(ans.numpy(),
                                  np.asarray(j_ans).argmax(1))

    repr_file = tmp_path / "genotype.txt"
    repr_file.write_text(repr(genotypes.PC_DARTS_cifar))
    again = load_artifact(path, device="cpu", genotype=str(repr_file),
                          compute_dtype="float32")
    assert torch.equal(again.generate(u8)[0], tok)

    with pytest.raises(ValueError, match="needs genotype"):
        load_artifact(path, device="cpu")
    with pytest.raises(ValueError, match="another network"):
        load_artifact(path, device="cpu", genotype="DARTS_V2")
