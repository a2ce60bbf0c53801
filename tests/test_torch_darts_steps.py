"""The 2-stage DARTS loop's steps (lctvqa_torch/train/experiment_darts.py:
`make_darts_steps`' train, eval and arch steps) against the JAX
package's on the CPU, in fp32 at the micro sizes of
tests/test_torch_architect.py (a supernet of one reduction cell of two
nodes) on 16-pixel images, batch 4, dropout off (the two packages draw
from different streams). Parameters are the JAX package's init, carried
across with `convert.from_jax`; the arch is moved off its uniform
mixture. Tolerances are stated at each test. Each JAX reference is
compiled once, with LLVM's optimizations off (`jax_compiled`); the
loader, experiment and CLI of the family are in tests/test_torch_darts.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lctvqa.models import vqa_ef as j_ef
from lctvqa.train.experiment_darts import make_darts_steps as j_darts_steps
from lctvqa_torch import convert
from lctvqa_torch.optim.optimizers import tree_leaves
from lctvqa_torch.train.experiment_darts import make_darts_steps
from test_torch_architect import jax_compiled, micro_cfgs
from test_torch_darts import MODEL, _flat, _trees_equal
from test_torch_train import (_assert_leaves_close, _t, jax_ref,  # noqa: F401
                              one_cpu_thread)
# (jax_ref and one_cpu_thread are fixtures, the second autouse)

B = 4
ETA = 0.01


def _cfgs(**train_kw):
    """(JAX config, port config) of the micro supernet, dropout off."""
    j_cfg, t_cfg = micro_cfgs(**MODEL)
    return tuple(c.replace(train=dataclasses.replace(c.train, **train_kw))
                 for c in (j_cfg, t_cfg))


def _batch(mcfg, seed):
    rng = np.random.default_rng(seed)
    return {
        "image_u8": rng.integers(0, 256, (B, mcfg.img_size, mcfg.img_size,
                                          3), dtype=np.uint8),
        "question": rng.integers(0, mcfg.qst_vocab_size,
                                 (B, mcfg.max_qst_len)).astype(np.int32),
        "answer_label": rng.integers(0, mcfg.ans_vocab_size, B).astype(
            np.int32),
        "answer_multi_choice": rng.integers(-1, mcfg.ans_vocab_size,
                                            (B, 10)).astype(np.int32),
    }


def _models(jm, seed=0):
    """The JAX package's EF params and an arch away from the uniform
    mixture."""
    params, arch = j_ef.init_ef_model(jax.random.PRNGKey(seed), jm)
    rng = np.random.default_rng(seed + 1)
    arch = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
            for k, v in arch.items()}
    return params, arch


@pytest.mark.parametrize("qst_only", [False, True],
                         ids=["answer+question", "qst_only"])
def test_darts_train_step_matches_jax(qst_only, jax_ref):
    """One train step: the loss within 1e-5 relative; Adam's step count
    equal, its first moment within 2e-3 of each leaf's scale plus 1e-10
    ((1 - b1) g: the gradient, through a batch-statistics BatchNorm over
    4 rows, as tests/test_torch_train.py's gradients); the new params
    within 1e-4 absolute. With qst_only the answer head gets no gradient
    and keeps its bits."""
    j_cfg, t_cfg = _cfgs()
    jm = j_cfg.model
    params, arch = _models(jm)
    batch = _batch(jm, 1)
    js = jax_ref(("darts", qst_only), lambda: j_darts_steps(
        j_cfg, 1, qst_only=qst_only))
    j_opt = js["tx"].init(params)
    want_p, want_opt, want_loss = jax_compiled(
        js["train"], params, j_opt, arch, batch, jax.random.PRNGKey(0))
    ts = make_darts_steps(t_cfg, 1, qst_only=qst_only)
    tp, ta = convert.from_jax(params), convert.from_jax(arch)
    got_p, got_opt, got_loss = ts["train"](tp, ts["tx"].init(tp), ta,
                                           _t(batch), torch.Generator())
    assert got_loss.dim() == 0 and not got_loss.requires_grad
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    want_state = convert.opt_state_from_jax(want_opt)
    assert got_opt["step"] == want_state["step"] == 1
    _assert_leaves_close(convert.to_jax(got_opt["m"]),
                         convert.to_jax(want_state["m"]), 2e-3, 1e-10)
    np.testing.assert_allclose(_flat(convert.to_jax(got_p)), _flat(want_p),
                               rtol=0, atol=1e-4)
    heads = [got_p[k] for k in ("fc1", "fc2")], [tp[k] for k in ("fc1",
                                                                 "fc2")]
    same = all(torch.equal(a, b) for a, b in zip(*map(tree_leaves, heads)))
    assert same == qst_only


def test_darts_eval_step_matches_jax(jax_ref):
    """eval: loss (answer + question CE) within 1e-5 relative; the
    unk-masked correct count and the greedy questions equal."""
    j_cfg, t_cfg = _cfgs()
    jm = j_cfg.model
    params, arch = _models(jm, seed=2)
    batch = _batch(jm, 3)
    batch["answer_multi_choice"][:, 0] = 1  # <unk> is an answer of each
    js = jax_ref(("darts", False), lambda: j_darts_steps(j_cfg, 1))
    want = jax_compiled(js["eval"], params, arch, batch,
                        jax.random.PRNGKey(0))
    got = make_darts_steps(t_cfg, 1)["eval"](
        convert.from_jax(params), convert.from_jax(arch), _t(batch))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    assert int(got[1]) == int(want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("mode", ["exact", "fd"])
def test_darts_arch_step_matches_jax(mode):
    """One arch step (the arch gradient on a train and a validation batch
    at eta, then Adam with weight decay): the validation loss within 1e-5
    relative; Adam's moments within 2e-4 ('exact': the same second
    derivatives, summed in another order; 2e-4 for the square of the
    gradient) or 2e-3 ('fd': a difference of two fp32 gradients divided
    by 2R, R = 1e-2 / ||v||, which scales their rounding by 1 / 2R) of
    each leaf's scale; the new arch within 2e-3 of the arch learning rate
    (a first Adam step is lr g / (|g| + eps), tests/
    test_torch_architect_steps.py). The mode the config names is the one
    that runs: 'exact-indirect', the default, is the finite difference."""
    j_cfg, t_cfg = _cfgs(architect_mode=mode)
    jm = j_cfg.model
    params, arch = _models(jm, seed=4)
    tb, vb = _batch(jm, 5), _batch(jm, 6)
    js = j_darts_steps(j_cfg, 1)
    j_opt = js["arch_tx"].init(arch)
    want_a, want_opt, want_v = jax_compiled(
        js["arch"], arch, j_opt, params, tb, vb, jnp.float32(ETA),
        jax.random.PRNGKey(0))
    ts = make_darts_steps(t_cfg, 1)
    ta = convert.from_jax(arch)
    got_a, got_opt, got_v = ts["arch"](
        ta, ts["arch_tx"].init(ta), convert.from_jax(params), _t(tb), _t(vb),
        ETA, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(got_v), float(want_v), rtol=1e-5)
    want_state = convert.opt_state_from_jax(
        want_opt, lr=t_cfg.train.arch_learning_rate)
    assert got_opt["step"] == want_state["step"] == 1
    tol = 2e-4 if mode == "exact" else 2e-3
    for key in ("m", "v"):
        _assert_leaves_close(convert.to_jax(got_opt[key]),
                             convert.to_jax(want_state[key]), tol)
    np.testing.assert_allclose(_flat(convert.to_jax(got_a)), _flat(want_a),
                               rtol=0, atol=2e-3 * 6e-4)
    if mode == "fd":
        # the default mode, exact-indirect, runs this step to the bit
        ts = make_darts_steps(_cfgs(architect_mode="exact-indirect")[1], 1)
        again = ts["arch"](ta, ts["arch_tx"].init(ta),
                           convert.from_jax(params), _t(tb), _t(vb), ETA,
                           torch.Generator().manual_seed(0))[0]
        assert _trees_equal(again, got_a)
