"""The port's DARTS second-order architect on the EF model and its whole
stage-3 step against the JAX package on the CPU, in fp32 at the micro
sizes of tests/test_architect.py, with the helpers of
tests/test_torch_architect.py (that file has the LCT architect's modes
and the twice-differentiable routes; the two are apart so that
`--dist loadfile` gives their JAX compiles two workers). Tolerances are
stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lctvqa.models import vqa_ef as j_ef
from lctvqa.optim.architect import make_darts_arch_grad as j_darts_arch_grad
from lctvqa.train import steps as j_steps
from lctvqa_torch import convert
from lctvqa_torch.models import vqa_ef
from lctvqa_torch.optim.architect import make_darts_arch_grad
from lctvqa_torch.optim.optimizers import tree_leaves
from lctvqa_torch.train import steps as t_steps
from test_torch_architect import (EF_LR, W_LR, cosine,  # noqa: F401
                                  dropout_off, flat, jax_compiled,
                                  micro_batches, micro_cfgs, micro_models)
from test_torch_train import (_assert_leaves_close, _t, jax_ref,  # noqa: F401
                              one_cpu_thread)
# (dropout_off, jax_ref and one_cpu_thread are fixtures, the last autouse)

ETA = 0.01


def _darts_setup():
    """The EF model of tests/test_architect.py's DARTS case (16 pixels,
    deterministic loss) in both packages."""
    j_cfg, t_cfg = micro_cfgs(img_size=16)
    jm, tm = j_cfg.model, t_cfg.model
    params, arch = j_ef.init_ef_model(jax.random.PRNGKey(2), jm)
    batches = micro_batches(jm, seed=3)

    def j_loss(p, a, batch, rng):
        return j_ef.ef_loss(p, a, jm, batch["image"], batch["question"],
                            batch["answer_label"], rng=None,
                            deterministic=True)

    def t_loss(p, a, batch, gen):
        return vqa_ef.ef_loss(p, a, tm, batch["image"], batch["question"],
                              batch["answer_label"], deterministic=True)

    return j_loss, t_loss, params, arch, batches


def _darts_grads(mode, jax_ref):
    """(port, JAX) arch gradient and validation loss of one mode."""
    j_loss, t_loss, params, arch, batches = _darts_setup()
    want = jax_ref(("darts", mode), lambda: jax_compiled(
        j_darts_arch_grad(j_loss, mode=mode), params, arch, *batches, ETA,
        jax.random.PRNGKey(3)))
    got = make_darts_arch_grad(t_loss, mode=mode)(
        convert.from_jax(params), convert.from_jax(arch), *_t(batches), ETA,
        torch.Generator().manual_seed(0))
    return got, want


@pytest.mark.parametrize("mode", ["exact", "fd"])
def test_darts_arch_grad_matches_jax(mode, jax_ref):
    """make_darts_arch_grad on the EF model's deterministic loss: the
    validation loss within 1e-5 relative; the arch gradient within 1e-4
    of each leaf's scale in 'exact' (the same second derivatives, sums in
    another order) and 2e-3 in 'fd' (a difference of two fp32 gradients
    divided by 2R, R = 1e-2 / ||v||)."""
    (got_g, got_v), (want_g, want_v) = _darts_grads(mode, jax_ref)
    np.testing.assert_allclose(float(got_v), float(want_v), rtol=1e-5)
    _assert_leaves_close(convert.to_jax(got_g), want_g,
                         1e-4 if mode == "exact" else 2e-3)


def test_darts_exact_vs_fd_on_ef_model(jax_ref):
    """tests/test_architect.py's check on the port: exact and the
    reference-style finite difference point the same way (cosine > 0.95)."""
    (g_exact, _), _ = _darts_grads("exact", jax_ref)
    (g_fd, _), _ = _darts_grads("fd", jax_ref)
    assert cosine(g_exact, g_fd) > 0.95


def _u8(batch, seed):
    """The batch with uint8 images for a step function (which normalizes
    them itself)."""
    rng = np.random.default_rng(seed)
    return dict(batch, image_u8=rng.integers(
        0, 256, batch["image"].shape, dtype=np.uint8))


def test_stage3_step_matches_jax(jax_ref, dropout_off):
    """One stage-3 step (normalize, exact-indirect arch gradient with
    remat, Adam with weight decay before the moments) against the JAX
    package's, dropout off: the W'-val loss within 1e-5 relative; Adam's
    step count equal and its moments within 2e-4 of each leaf's scale
    (the first moment is (1 - b1) g, the second (1 - b2) g^2: the
    gradient's 1e-4, twice for the square); the new arch within 2e-3 of
    the learning rate: a first Adam step is lr * g / (|g| + eps), which
    turns a relative error d of an element of g near eps = 1e-8 into up
    to d * |g| / (4 eps) of lr."""
    j_cfg, t_cfg = micro_cfgs()
    ef_params, arch, w_params = micro_models(j_cfg.model, seed=7)
    tb, vb = (_u8(b, s) for b, s in zip(micro_batches(j_cfg.model, seed=8),
                                        (9, 10)))
    js = j_steps.make_lct_steps(j_cfg, unk_idx=1)
    j_opt = js["arch_tx"].init(arch)
    want_arch, want_opt, want_v = jax_compiled(
        js["stage3"], arch, j_opt, ef_params, w_params, tb, vb,
        jnp.float32(EF_LR), jnp.float32(W_LR), jax.random.PRNGKey(0))
    ts = t_steps.make_lct_steps(t_cfg, 1, "cpu")
    ta = convert.from_jax(arch)
    t_opt = ts["arch_tx"].init(ta)
    got_arch, got_opt, got_v = ts["stage3"](
        ta, t_opt, convert.from_jax(ef_params), convert.from_jax(w_params),
        _t(tb), _t(vb), EF_LR, W_LR, torch.Generator().manual_seed(0))
    assert got_v.dim() == 0
    np.testing.assert_allclose(float(got_v), float(want_v), rtol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ta), tree_leaves(
        convert.from_jax(arch))))  # the inputs are left as they are
    want_state = convert.opt_state_from_jax(
        want_opt, lr=t_cfg.train.arch_learning_rate)
    assert got_opt["step"] == want_state["step"] == 1
    for key in ("m", "v"):
        _assert_leaves_close(convert.to_jax(got_opt[key]),
                             convert.to_jax(want_state[key]), 2e-4)
    lr = t_cfg.train.arch_learning_rate
    np.testing.assert_allclose(flat(got_arch), flat(want_arch), rtol=0,
                               atol=2e-3 * lr)
    assert not any(torch.equal(a, b) for a, b in zip(tree_leaves(got_arch),
                                                     tree_leaves(ta)))
