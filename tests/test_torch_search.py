"""The port's PC-DARTS supernet (lctvqa_torch/models/search.py) against
the JAX package's, on the CPU in fp32 at `small_test_config` dims.

Params come from the JAX package's own init and go through
`lctvqa_torch.convert`; inputs come from a seeded numpy generator and go
to both packages. Tolerance 1e-4 (that of
tests/test_full_model_torch_parity.py), greedy tokens exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lctvqa.config import small_test_config
from lctvqa.models import search as j_search
from lctvqa.models import vqa_ef as j_ef
from lctvqa.models.genotypes import PRIMITIVES
from lctvqa.ops import conv as j_conv
from lctvqa_torch import convert
from lctvqa_torch.models import search as t_search
from lctvqa_torch.models import vqa_ef as t_ef
from lctvqa_torch.ops import conv as t_conv
from test_torch_train import one_cpu_thread  # noqa: F401 (autouse)

TOL = 1e-4
MCFG = small_test_config().model
assert MCFG.arch_type == "darts" and MCFG.compute_dtype == "float32"
ALL_PRIMS = PRIMITIVES + ("sep_conv_7x7", "conv_7x1_1x7")
CH = 8  # width of the op-level inputs


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _x(seed, shape=(3, 10, 8, CH)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _weights(seed, shape):
    """Mixture weights as a softmax of seeded logits."""
    w = np.exp(np.random.default_rng(seed).standard_normal(shape))
    return (w / w.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("prim", ALL_PRIMS)
def test_op_matches(prim, stride):
    p = _np_tree(j_search.op_init(jax.random.PRNGKey(3), prim, CH, stride))
    x = _x(0)
    want = j_search.op_apply(p, prim, jnp.asarray(x), stride, None)
    got = t_search.op_apply(convert.from_jax(p), prim, torch.from_numpy(x),
                            stride, None)
    assert got.shape == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("fold_bn", [True, False], ids=["fold", "unfolded"])
def test_mixed_op_matches(fold_bn, stride):
    k = 4
    p = _np_tree(j_search.mixed_op_init(jax.random.PRNGKey(4), CH * k,
                                        stride, k))
    x = _x(1, (3, 10, 8, CH * k))
    w = _weights(2, (len(PRIMITIVES),))
    want = j_search.mixed_op_apply(p, jnp.asarray(x), jnp.asarray(w), stride,
                                   k, None, fold_bn=fold_bn)
    got = t_search.mixed_op_apply(convert.from_jax(p), torch.from_numpy(x),
                                  torch.from_numpy(w), stride, k, None,
                                  fold_bn=fold_bn)
    _close(got, want)


@pytest.mark.parametrize("reduction", [False, True],
                         ids=["normal", "reduction"])
def test_cell_matches(reduction):
    steps, mult, k, c = 3, 3, 4, 8
    p = _np_tree(j_search.cell_init(jax.random.PRNGKey(5), steps, 12, 12, c,
                                    reduction, False, k))
    s0, s1 = _x(3, (2, 8, 8, 12)), _x(4, (2, 8, 8, 12))
    n_edges = j_search.num_edges(steps)
    alphas = _weights(5, (n_edges, len(PRIMITIVES)))
    betas = np.asarray(j_search.beta_softmax(
        jnp.asarray(_x(6, (n_edges,))), steps))
    want = j_search.cell_apply(p, jnp.asarray(s0), jnp.asarray(s1),
                               jnp.asarray(alphas), jnp.asarray(betas), steps,
                               mult, reduction, False, k, None, fold_bn=True)
    got = t_search.cell_apply(convert.from_jax(p), torch.from_numpy(s0),
                              torch.from_numpy(s1), torch.from_numpy(alphas),
                              torch.from_numpy(betas), steps, mult, reduction,
                              False, k, None, fold_bn=True)
    assert got.shape == (2, 4 if reduction else 8, 4 if reduction else 8,
                         mult * c)
    _close(got, want)
    _close(t_search.beta_softmax(torch.from_numpy(_x(6, (n_edges,))), steps),
           betas)


@pytest.fixture(scope="module")
def ef():
    params, arch = j_ef.init_ef_model(jax.random.PRNGKey(1), MCFG)
    # arch params off their 1e-3 init, so that the mixture is not uniform
    rng = np.random.default_rng(7)
    arch = {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in arch.items()}
    return _np_tree(params), arch


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(8)
    img = rng.standard_normal((3, MCFG.img_size, MCFG.img_size, 3)).astype(
        np.float32)
    qst = rng.integers(0, MCFG.qst_vocab_size, (3, MCFG.max_qst_len),
                       dtype=np.int32)
    return img, qst


@pytest.mark.parametrize("fold_bn", [True, False], ids=["fold", "unfolded"])
def test_network_matches(ef, batch, fold_bn):
    params, arch = ef
    cfg = dataclasses.replace(MCFG, fold_bn_mixture=fold_bn)
    want = j_search.network_apply(params["darts"], arch, cfg,
                                  jnp.asarray(batch[0]))
    got = t_search.network_apply(convert.from_jax(params["darts"]),
                                 convert.from_jax(arch), cfg,
                                 torch.from_numpy(batch[0]))
    assert got.shape == (3, t_search.network_out_features(cfg))
    assert (t_search.network_out_features(cfg)
            == j_search.network_out_features(cfg))
    _close(got, want)


def test_ef_darts_forward_and_generate_match(ef, batch):
    params, arch = ef
    img, qst = batch
    t_params, t_arch = convert.from_jax(params), convert.from_jax(arch)
    want_ans, want_qst = j_ef.ef_forward(params, arch, MCFG, jnp.asarray(img),
                                         jnp.asarray(qst))
    got_ans, got_qst = t_ef.ef_forward(t_params, t_arch, MCFG,
                                       torch.from_numpy(img),
                                       torch.from_numpy(qst))
    _close(got_ans, want_ans)
    _close(got_qst, want_qst)
    want_tok, want_gen = j_ef.ef_generate(params, arch, MCFG,
                                          jnp.asarray(img))
    got_tok, got_gen = t_ef.ef_generate(t_params, t_arch, MCFG,
                                        torch.from_numpy(img))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    _close(got_gen, want_gen)


def test_init_shapes_match_jax():
    """The port's own init builds the JAX package's tree, leaf for leaf."""
    want_p, want_a = j_ef.init_ef_model(jax.random.PRNGKey(0), MCFG)
    got_p, got_a = t_ef.init_ef_model(torch.Generator().manual_seed(0), MCFG)
    for got, want in ((got_p, want_p), (got_a, want_a)):
        got = convert.to_jax(got)
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(_np_tree(want)))
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert a.shape == b.shape and a.dtype == b.dtype
    assert float(got_a["alphas_normal"].abs().max()) < 1e-2


def test_convert_search_tree_round_trip_is_exact(ef):
    params, arch = ef
    for tree in (params, arch):
        back = convert.to_jax(convert.from_jax(tree))
        assert (jax.tree_util.tree_structure(back)
                == jax.tree_util.tree_structure(tree))
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(tree)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # depthwise HWIO [k, k, 1, C] -> OIHW [C, 1, k, k]; 1x7 and 7x1 too
    op = params["darts"]["cells"][0]["ops"][2]["sep_conv_5x5"]["dw1"]["w"]
    cs = op.shape[3]
    assert op.shape == (5, 5, 1, cs)
    assert convert.from_jax(op).shape == (cs, 1, 5, 5)
    p7 = _np_tree(j_search.op_init(jax.random.PRNGKey(2), "conv_7x1_1x7", CH,
                                   1))
    t7 = convert.from_jax(p7)
    assert t7["conv_1x7"]["w"].shape == (CH, CH, 1, 7)
    assert t7["conv_7x1"]["w"].shape == (CH, CH, 7, 1)
    np.testing.assert_array_equal(t7["conv_1x7"]["w"][2, 5, 0, 3].numpy(),
                                  p7["conv_1x7"]["w"][0, 3, 5, 2])


@pytest.mark.parametrize("case", ["avg_pool_counts", "channel_shuffle"])
def test_index_maps(case):
    if case == "avg_pool_counts":
        # ones in, so the output is 1 exactly where the divisor is the
        # count of valid elements; and a ramp against the JAX package
        ones = torch.ones(1, 5, 4, 2)
        assert torch.equal(t_conv.avg_pool(ones, 3, 1, 1), ones)
        assert torch.equal(t_conv.avg_pool(ones, 3, 2, 1),
                           torch.ones(1, 3, 2, 2))
        ramp = np.arange(40, dtype=np.float32).reshape(1, 5, 4, 2)
        for stride in (1, 2):
            _close(t_conv.avg_pool(torch.from_numpy(ramp), 3, stride, 1),
                   j_conv.avg_pool(jnp.asarray(ramp), 3, stride, 1))
        corner = t_conv.avg_pool(torch.from_numpy(ramp), 3, 1, 1)[0, 0, 0, 0]
        assert float(corner) == pytest.approx((0 + 2 + 8 + 10) / 4)
    else:
        c, groups = 12, 4
        x = np.arange(c, dtype=np.float32).reshape(1, 1, 1, c)
        got = t_search.channel_shuffle(torch.from_numpy(x), groups)
        want = j_search.channel_shuffle(jnp.asarray(x), groups)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # channel g * (c / groups) + i moves to i * groups + g
        per = c // groups
        for g in range(groups):
            for i in range(per):
                assert got[0, 0, 0, i * groups + g] == g * per + i


def test_genotype_decode_matches(ef):
    _, arch = ef
    want = j_search.genotype(arch, MCFG.darts_steps, MCFG.darts_multiplier)
    got = t_search.genotype(convert.from_jax(arch), MCFG.darts_steps,
                            MCFG.darts_multiplier)
    assert tuple(got) == tuple(want)


def test_derived_ef_needs_its_genotype():
    """A derived EF needs its genotype, as the JAX package's assert
    says."""
    with pytest.raises(ValueError, match="needs genotype"):
        t_ef.init_ef_model(torch.Generator().manual_seed(0),
                           dataclasses.replace(MCFG, arch_type="derived"))
