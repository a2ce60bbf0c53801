"""The port's stage-3 architects against the JAX package on the CPU, in
fp32 at the micro sizes of tests/test_architect.py: the tri-level LCT
architect in its three modes, `sgd_step`, the DARTS architect on the
analytic bilevel quadratic, and the twice-differentiable routes the
architects take (no kernel reached, the avg pool's second order, the
plain BatchNorm under `second_order`). The DARTS architect on the EF
model and the whole stage-3 step against the JAX package are in
tests/test_torch_architect_steps.py, so that `--dist loadfile` gives the
two files' JAX compiles two workers.

The same numpy-seeded inputs and the same parameters (initialised by the
JAX package, carried across with lctvqa_torch.convert) go through both;
dropout is off where the two are compared (the packages draw from
different random streams) and on where the port is compared with itself.
Tolerances are stated at each test; arch gradients are compared leaf by
leaf, relative to each leaf's scale. Each JAX reference is jitted once
per module and compiled with LLVM's optimizations off
(`jax_compiled`): a reference is run once, and its compile is most of
the file's time.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lctvqa.config import small_test_config as j_small_config
from lctvqa.models import vqa_ef as j_ef, vqa_w as j_w
from lctvqa.ops import nn as j_nn
from lctvqa.optim import optimizers as j_optim
from lctvqa.optim.architect_lct import make_lct_arch_grad as j_lct_arch_grad
from lctvqa_torch import convert
from lctvqa_torch.config import small_test_config
from lctvqa_torch.ops import (conv as t_conv, cuda_bn, cuda_generate,
                              cuda_lstm, cuda_mixedop, nn as t_nn)
from lctvqa_torch.optim import architect_lct as t_lct
from lctvqa_torch.optim.architect import make_darts_arch_grad
from lctvqa_torch.optim.optimizers import sgd_step, tree_leaves
from test_torch_train import (_assert_leaves_close, _t, jax_ref,  # noqa: F401
                              one_cpu_thread)
# (jax_ref and one_cpu_thread are fixtures, the second autouse)

# the micro model of tests/test_architect.py: one reduction cell of two
# nodes, VGG19 at 1/16 width (it needs 32 pixels)
MICRO = dict(img_size=32, img_embed_size=16, word_embed_size=8,
             lstm_hidden_size=16, max_qst_len=4, qst_vocab_size=16,
             ans_vocab_size=8, darts_init_ch=4, darts_layers=1, darts_steps=2,
             darts_multiplier=2, vgg_width_mult=1 / 16, vgg_fc_dim=32)
# LLVM's optimizations off for the JAX references: the same operations,
# compiled in half the time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
EF_LR = W_LR = 0.01


@pytest.fixture
def dropout_off(monkeypatch):
    """Dropout as the identity in both packages. The architects run their
    models with dropout on, and W's VGG has a hard-coded rate of 0.5
    that `dropout_rate = 0` does not reach; the two packages draw their
    masks from different streams."""
    for mod in (j_nn, t_nn):
        monkeypatch.setattr(mod, "dropout", lambda x, *a, **k: x)


def micro_cfgs(**model_kw):
    """(JAX config, port config) of the micro model, stage 3 on."""
    out = []
    for make in (j_small_config, small_test_config):
        cfg = make()
        out.append(cfg.replace(model=dataclasses.replace(
            cfg.model, **{**MICRO, **model_kw})))
    return out


def jax_compiled(fn, *args):
    """fn(*args) through jax.jit, compiled with FAST_COMPILE."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def micro_batches(mcfg, seed=0, b=2):
    """A train and a validation batch of normalized float images."""
    rng = np.random.default_rng(seed)

    def mk():
        return {"image": rng.standard_normal(
                    (b, mcfg.img_size, mcfg.img_size, 3)).astype(np.float32),
                "question": rng.integers(0, mcfg.qst_vocab_size,
                                         (b, mcfg.max_qst_len)).astype(
                                             np.int32),
                "answer_label": rng.integers(0, mcfg.ans_vocab_size,
                                             b).astype(np.int32)}

    return mk(), mk()


def micro_models(jm, seed=4):
    """The JAX package's EF params, arch and W params for the micro model."""
    kef, kw = jax.random.split(jax.random.PRNGKey(seed))
    ef_params, arch = j_ef.init_ef_model(kef, jm)
    return ef_params, arch, j_w.init_w_model(kw, jm)


def flat(tree) -> np.ndarray:
    """A JAX-layout tree's or a port tree's leaves as one vector."""
    if isinstance(tree_leaves(tree)[0], torch.Tensor):
        tree = convert.to_jax(tree)
    return np.concatenate([np.asarray(v).ravel()
                           for v in jax.tree_util.tree_leaves(tree)])


def cosine(a, b) -> float:
    fa, fb = flat(a), flat(b)
    assert np.isfinite(fa).all() and np.isfinite(fb).all()
    denom = np.linalg.norm(fa) * np.linalg.norm(fb)
    assert denom > 0
    return float(np.dot(fa, fb)) / denom


def port_arch_grad(t_cfg, mode, batches, models, **train_kw):
    """The port's tri-level arch gradient on numpy batches and JAX-layout
    models, dropout seeds from generator seed 0."""
    tcfg = dataclasses.replace(t_cfg.train, **train_kw)
    ef_params, arch, w_params = (convert.from_jax(m) for m in models)
    fn = t_lct.make_lct_arch_grad(t_cfg.model, tcfg, mode)
    return fn(arch, ef_params, w_params, *_t(batches), EF_LR, W_LR,
              torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# sgd_step and the DARTS architect's exact mode on a quadratic
# ---------------------------------------------------------------------------

def test_sgd_step_matches_jax():
    """w - lr * g over a tree, exactly; a leaf with no gradient (None,
    as autograd gives for the frozen VGG trunk) stays as it is, as a zero
    gradient leaves it in the JAX package."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32),
                    rng.standard_normal((2, 2, 3, 4)).astype(np.float32)]}
    grads = {"a": rng.standard_normal((3, 4)).astype(np.float32),
             "b": [np.zeros(5, np.float32),
                   rng.standard_normal((2, 2, 3, 4)).astype(np.float32)]}
    want = j_optim.sgd_step(jax.tree_util.tree_map(jnp.asarray, params),
                            jax.tree_util.tree_map(jnp.asarray, grads),
                            jnp.float32(0.3))
    tp = convert.from_jax(params)
    tg = tree_leaves(convert.from_jax(grads))
    tg[1] = None
    got = sgd_step(tp, tg, 0.3)
    assert got["b"][0] is tp["b"][0]
    for a, b in zip(jax.tree_util.tree_leaves(convert.to_jax(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_darts_exact_matches_analytic_quadratic():
    """Bilevel toy (tests/test_architect.py): L(w, a) = 0.5 (w - a)^2 on
    train, L_val = 0.5 (w - c)^2; w' = w - eta (w - a), dL_val/da =
    (w' - c) eta. Exact to 1e-6; 'fd' to 1e-4 (a central difference in
    fp32 of a function quadratic in w: rounding only)."""
    eta, c = 0.3, 2.0

    def loss_fn(params, arch, batch, gen):
        w, a = params["w"], arch["a"]
        tgt = torch.where(batch["t"] > 0, torch.tensor(c), a)
        return 0.5 * ((w - tgt) ** 2).sum()

    w_unrolled = 1.5 - eta * (1.5 - 0.7)
    for mode, tol in (("exact", 1e-6), ("fd", 1e-4)):
        g, val_loss = make_darts_arch_grad(loss_fn, mode=mode)(
            {"w": torch.tensor(1.5)}, {"a": torch.tensor(0.7)},
            {"t": torch.tensor(0.0)}, {"t": torch.tensor(1.0)}, eta,
            torch.Generator().manual_seed(0))
        np.testing.assert_allclose(float(g["a"]), (w_unrolled - c) * eta,
                                   rtol=tol)
        np.testing.assert_allclose(float(val_loss),
                                   0.5 * (w_unrolled - c) ** 2, rtol=1e-6)


# ---------------------------------------------------------------------------
# the LCT tri-level architect against the JAX package
# ---------------------------------------------------------------------------

# arch gradient tolerance relative to each leaf's scale: 'exact' modes take
# the same second derivatives in another order of sums (3e-5 and 1.3e-5
# seen); 'fd' divides differences of two fp32 gradients by 2R twice over
# (R = 1e-2 / ||v||), which turns their rounding, 1e-7 of a probe
# gradient, into about 1e-4 of the result (2e-4 seen)
ARCH_GRAD_TOL = {"exact": 1e-4, "exact-indirect": 1e-4, "fd": 2e-3}


@pytest.mark.parametrize("mode", ["exact", "exact-indirect", "fd"])
def test_lct_arch_grad_matches_jax(mode, jax_ref, dropout_off):
    """make_lct_arch_grad with dropout off: the unrolled validation loss
    within 1e-5 relative, the arch gradient within ARCH_GRAD_TOL[mode] of
    each leaf's scale, finite and nonzero (the full 'exact' gradient
    included, tests/test_architect.py:127)."""
    j_cfg, t_cfg = micro_cfgs()
    batches = micro_batches(j_cfg.model)
    models = micro_models(j_cfg.model)
    ef_params, arch, w_params = models
    want_g, want_v = jax_ref(("lct", mode), lambda: jax_compiled(
        j_lct_arch_grad(j_cfg.model, j_cfg.train, mode), arch, ef_params,
        w_params, *batches, EF_LR, W_LR, jax.random.PRNGKey(0)))
    got_g, got_v = port_arch_grad(t_cfg, mode, batches, models)
    assert got_v.dim() == 0 and not got_v.requires_grad
    np.testing.assert_allclose(float(got_v), float(want_v), rtol=1e-5)
    assert all(not g.requires_grad for g in tree_leaves(got_g))
    _assert_leaves_close(convert.to_jax(got_g), want_g, ARCH_GRAD_TOL[mode])
    assert np.abs(flat(got_g)).sum() > 0


def test_lct_fd_matches_indirect_exact():
    """tests/test_architect.py:107 on the port alone, dropout on: the
    reference's finite-difference chain against the gradient through two
    unrolls with the direct alpha -> generate path cut. Both draw the
    same masks from the same seeds, so their validation losses are one
    value; the gradients point the same way (cosine > 0.9)."""
    j_cfg, t_cfg = micro_cfgs()
    batches = micro_batches(j_cfg.model, seed=1)
    models = micro_models(j_cfg.model, seed=5)
    g_ind, v1 = port_arch_grad(t_cfg, "exact-indirect", batches, models)
    g_fd, v2 = port_arch_grad(t_cfg, "fd", batches, models)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-6)
    assert cosine(g_ind, g_fd) > 0.9


@pytest.mark.parametrize("mode", ["exact", "exact-indirect"])
def test_remat_on_and_off_agree(mode):
    """stage3_remat recomputes EF's train loss and W's soft loss in the
    outer backward (torch.utils.checkpoint); with dropout on, the
    recomputed forward must draw the same masks: gradients within 1e-6 of
    their scale, losses equal."""
    j_cfg, t_cfg = micro_cfgs()
    batches = micro_batches(j_cfg.model, seed=2)
    models = micro_models(j_cfg.model, seed=6)
    g_on, v_on = port_arch_grad(t_cfg, mode, batches, models,
                                stage3_remat=True)
    g_off, v_off = port_arch_grad(t_cfg, mode, batches, models,
                                  stage3_remat=False)
    assert float(v_on) == float(v_off)
    _assert_leaves_close(convert.to_jax(g_on), convert.to_jax(g_off), 1e-6)


def test_architects_never_reach_a_kernel(monkeypatch):
    """The port's form of test_architects_never_route_to_pallas_lstm:
    every kernel flag and USE_PALLAS_BN on, every kernel entry point
    patched to raise; both architects still run (their closures take the
    plain versions), and USE_PALLAS_BN is on again afterwards."""
    def boom(*a, **k):
        raise AssertionError("an architect reached a kernel entry point")

    for mod, name in ((cuda_lstm, "lstm_cell"), (cuda_lstm, "lstm_seq_final"),
                      (cuda_lstm, "lstm_seq"),
                      (cuda_generate, "greedy_generate"),
                      (cuda_mixedop, "mixed_node"),
                      (cuda_bn, "batchnorm_fwd")):
        monkeypatch.setattr(mod, name, boom)
    monkeypatch.setattr(t_conv, "USE_PALLAS_BN", True)
    flags = dict(use_pallas_lstm=True, pallas_seq_lstm=True,
                 pallas_generate=True, pallas_mixed_op=True)
    j_cfg, t_cfg = micro_cfgs(**flags)
    batches = micro_batches(j_cfg.model)
    models = micro_models(j_cfg.model)
    for mode in t_lct.MODES:
        g, v = port_arch_grad(t_cfg, mode, batches, models)
        assert np.isfinite(float(v)) and np.isfinite(flat(g)).all()
    assert t_conv.USE_PALLAS_BN
    # the patched entry points do raise where the flags route to them
    from lctvqa_torch.models import vqa_ef
    ef_params, arch, _ = (convert.from_jax(m) for m in models)
    with pytest.raises(AssertionError, match="kernel entry point"):
        vqa_ef.ef_forward(ef_params, arch, t_cfg.model,
                          torch.from_numpy(batches[0]["image"]),
                          torch.from_numpy(batches[0]["question"]))


# ---------------------------------------------------------------------------
# the twice-differentiable routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
def test_avg_pool_second_order(stride):
    """The port's avg pool (its backward on contiguous tensors) has the
    second derivative of F.avg_pool2d on an NCHW tensor: a Hessian-vector
    product through a loss that squares the pooled output, on a channel
    slice of an NHWC tensor as the supernet pools it, within 1e-6."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 8, 8, 12, generator=gen)
    v = torch.randn(2, 8, 8, 12, generator=gen)
    out = []
    for pool in (lambda t: t_conv.avg_pool(t[..., :4], 3, stride, 1),
                 lambda t: torch.nn.functional.avg_pool2d(
                     t[..., :4].permute(0, 3, 1, 2).contiguous(), 3, stride,
                     1, count_include_pad=False)):
        xg = x.clone().requires_grad_()
        (g,) = torch.autograd.grad((pool(xg) ** 3).sum(), xg,
                                   create_graph=True)
        (hv,) = torch.autograd.grad((g * v).sum(), xg)
        out.append((g.detach(), hv))
    for got, want in zip(*out):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert float(out[0][1].abs().max()) > 0


def test_second_order_takes_the_plain_batchnorm(monkeypatch):
    """Under `second_order` an affine-free batchnorm of a tensor off the
    CPU takes the plain route with USE_PALLAS_BN on (a meta tensor stands
    for a card's); outside it, the kernel's wrapper. The switch itself is
    left as it was."""
    calls = []
    monkeypatch.setattr(cuda_bn, "batchnorm_fwd",
                        lambda x, out_dtype=None: calls.append(x) or x)
    monkeypatch.setattr(t_conv, "USE_PALLAS_BN", True)
    x = torch.empty(4, 3, 3, 8, device="meta")
    t_conv.batchnorm({}, x)
    assert len(calls) == 1
    with t_conv.second_order():
        y = t_conv.batchnorm({}, x)
        assert not torch.backends.cudnn.allow_tf32
    assert len(calls) == 1 and y.shape == x.shape and t_conv.USE_PALLAS_BN
