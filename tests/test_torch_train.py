"""The port's training slice (lctvqa_torch: losses, gradients, optimizer,
steps, running BatchNorm statistics, data, checkpoints, Experiment, CLI)
against the JAX package on the CPU, in fp32 at `small_test_config` sizes.

The same numpy-seeded inputs and the same parameters (initialised by the
JAX package, converted with lctvqa_torch.convert) go through both.
Tolerances are stated at each test; gradients are compared leaf by leaf,
relative to each leaf's own scale. Parameters after an Adam step are not
compared: from zero moments the first update is lr * g / (|g| + eps),
which keeps the sign of g and loses its size, so that two right
implementations differ by 100% on a leaf whose gradient is near eps.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lctvqa.config import small_test_config as j_small_config
from lctvqa.models import vqa_ef as j_ef, vqa_w as j_w
from lctvqa.ops import conv as j_conv, losses as j_losses
from lctvqa.optim import optimizers as j_optim
from lctvqa.train import checkpoint as j_ckpt, steps as j_steps
from lctvqa_torch import convert
from lctvqa_torch.config import small_test_config
from lctvqa_torch.data import pipeline, synthetic
from lctvqa_torch.models import vqa_ef, vqa_w
from lctvqa_torch.models.qst_encoder import ef_qst_generate
from lctvqa_torch.ops import conv as t_conv, losses
from lctvqa_torch.optim import optimizers as t_optim
from lctvqa_torch.optim.optimizers import tree_leaves, tree_map
from lctvqa_torch.train import checkpoint, steps as t_steps
from lctvqa_torch.train.experiment import Experiment

REPO = Path(__file__).resolve().parents[1]
B = 8


def _cfgs(**model_kw):
    """(JAX config, port config) of the same small model, stage 3 off."""
    out = []
    for make in (j_small_config, small_test_config):
        cfg = make()
        out.append(cfg.replace(
            model=dataclasses.replace(cfg.model, **model_kw),
            train=dataclasses.replace(cfg.train, skip_stage3=True)))
    return out


def _batch(mcfg, seed=0, b=B):
    rng = np.random.default_rng(seed)
    return {
        "image_u8": rng.integers(0, 256, (b, mcfg.img_size, mcfg.img_size, 3),
                                 dtype=np.uint8),
        "question": rng.integers(0, mcfg.qst_vocab_size,
                                 (b, mcfg.max_qst_len)).astype(np.int32),
        "answer_label": rng.integers(0, mcfg.ans_vocab_size, b).astype(
            np.int32),
        "answer_multi_choice": rng.integers(-1, mcfg.ans_vocab_size,
                                            (b, 10)).astype(np.int32),
    }


def _image(mcfg, seed=0, b=B):
    """A float image from a seed: no two values tie in a max pool."""
    return np.random.default_rng(seed).standard_normal(
        (b, mcfg.img_size, mcfg.img_size, 3)).astype(np.float32)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _assert_leaves_close(got, want, tol, floor=0.0):
    """Every leaf of `got` (JAX layout, numpy) within tol * its scale of
    `want`'s; `floor` is an absolute allowance for leaves whose gradient
    is rounding noise."""
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want)
    for (path, a), b in zip(flat_got, flat_want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        assert err <= tol * scale + floor, (
            f"{jax.tree_util.keystr(path)}: err {err}, scale {scale}")


def _grads_to_jax(params, grads):
    """autograd.grad's list over tree_leaves(params) -> a JAX-layout tree,
    zeros where the loss does not reach a leaf."""
    it = iter(grads)
    return convert.to_jax(tree_map(
        lambda p: (lambda g: torch.zeros_like(p) if g is None else g)(
            next(it)), params))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    """cross_entropy, soft_xent and the unmasked teacher-forcing CE within
    1e-6 (fp32 log-softmax in another order)."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, 6).astype(np.int32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((6, 11)).astype(np.float32))))
    seq = rng.standard_normal((4, 7, 11)).astype(np.float32)
    qst = rng.integers(0, 11, (4, 7)).astype(np.int32)
    qst[:, 5:] = 0  # pads are ordinary targets
    pairs = [
        (losses.cross_entropy(*_t((logits, labels))),
         j_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        (losses.soft_xent(*_t((logits, probs))),
         j_losses.soft_xent(jnp.asarray(logits), jnp.asarray(probs))),
        (losses.sequence_teacher_forcing_ce(*_t((seq, qst))),
         j_losses.sequence_teacher_forcing_ce(jnp.asarray(seq),
                                              jnp.asarray(qst))),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-6)
    # masking the pads would change the value: the quirk is kept
    masked = losses.cross_entropy(
        torch.from_numpy(seq[:, :4].reshape(-1, 11)),
        torch.from_numpy(qst[:, 1:5].reshape(-1)))
    assert abs(float(masked) - float(pairs[2][0])) > 1e-3


# ---------------------------------------------------------------------------
# gradients of the two losses, leaf by leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_type,flags", [
    ("darts", {}), ("darts", {"pallas_mixed_op": True}),
    ("darts", {"fold_bn_mixture": False}), ("fixed", {}),
    ("fixed", {"pretrained_enc": False})],
    ids=["darts", "darts-node", "darts-unfolded", "fixed-frozen",
         "fixed-trained"])
def test_ef_loss_gradients_match_jax(arch_type, flags):
    """ef_loss and its gradient w.r.t. every leaf of the EF params and,
    for the supernet, the arch parameters. Loss within 1e-5; each leaf
    within 2e-3 of its own scale plus 1e-7: the supernet's gradient goes
    through two cells of batch-statistics BatchNorm over a batch of 8,
    which amplify the summation-order difference of two fp32
    implementations (the JAX package's own test of two of its paths
    allows 3% per leaf). With `pallas_mixed_op` the port runs the node
    kernel's plain version and the JAX package its default path."""
    # VGG19 halves the image five times: it needs 32 pixels at least
    size = {"img_size": 32} if arch_type == "fixed" else {}
    j_cfg, t_cfg = _cfgs(arch_type=arch_type, **size, **flags)
    jm = dataclasses.replace(j_cfg.model, pallas_mixed_op=False)
    tm = t_cfg.model
    params, arch = j_ef.init_ef_model(jax.random.PRNGKey(0), jm)
    if arch is not None:  # away from the uniform mixture
        arch = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.random.default_rng(1).standard_normal(
                a.shape).astype(np.float32)), arch)
    img = _image(jm)
    batch = _batch(jm)
    qst, labels = batch["question"], batch["answer_label"]

    def j_loss(p, a):
        return j_ef.ef_loss(p, a, jm, jnp.asarray(img), jnp.asarray(qst),
                            jnp.asarray(labels), deterministic=True)

    want, (want_p, want_a) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        params, arch)
    tp = t_steps.with_grad(convert.from_jax(params))
    ta = (None if arch is None
          else t_steps.with_grad(convert.from_jax(arch)))
    got = vqa_ef.ef_loss(tp, ta, tm, torch.from_numpy(img),
                         torch.from_numpy(qst), torch.from_numpy(labels),
                         deterministic=True)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-5)
    leaves = tree_leaves(tp) + tree_leaves(ta)
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    n = len(tree_leaves(tp))
    _assert_leaves_close(_grads_to_jax(tp, grads[:n]), want_p, 2e-3, 1e-7)
    if arch is not None:
        _assert_leaves_close(_grads_to_jax(ta, grads[n:]), want_a, 2e-3, 1e-7)
    if arch_type == "fixed":
        frozen = all(g is None for g in grads[:len(tree_leaves(tp["vgg"]))])
        assert frozen == tm.pretrained_enc


def test_ef_loss_qst_only_drops_the_answer_term():
    _, t_cfg = _cfgs()
    tm = t_cfg.model
    params, arch = vqa_ef.init_ef_model(torch.Generator().manual_seed(0), tm)
    batch = _t(_batch(tm))
    img = torch.from_numpy(_image(tm))
    full = vqa_ef.ef_loss(params, arch, tm, img, batch["question"],
                          batch["answer_label"])
    only = vqa_ef.ef_loss(params, arch, tm, img, batch["question"],
                          batch["answer_label"], qst_only=True)
    ans, _ = vqa_ef.ef_forward(params, arch, tm, img, batch["question"])
    torch.testing.assert_close(
        full - only, losses.cross_entropy(ans, batch["answer_label"]))


def test_w_soft_loss_gradients_match_jax():
    """w_soft_loss(deterministic=True) and its gradient per leaf: loss
    within 1e-5, leaves within 1e-4 of their scale. The VGG trunk is
    always detached: its leaves get no gradient in the port and exact
    zeros in the JAX package."""
    j_cfg, t_cfg = _cfgs(img_size=32)
    jm, tm = j_cfg.model, t_cfg.model
    params = j_w.init_w_model(jax.random.PRNGKey(2), jm)
    rng = np.random.default_rng(3)
    img, batch = _image(jm), _batch(jm)
    pseudo_qst = rng.integers(0, jm.qst_vocab_size,
                              (B, jm.max_qst_len)).astype(np.int32)
    pseudo_ans = np.asarray(jax.nn.softmax(jnp.asarray(rng.standard_normal(
        (B, jm.ans_vocab_size)).astype(np.float32))))
    args = (img, batch["question"], batch["answer_label"], pseudo_qst,
            pseudo_ans)
    want, want_g = jax.value_and_grad(
        lambda p: j_w.w_soft_loss(p, jm, *map(jnp.asarray, args), 0.7,
                                  deterministic=True))(params)
    tp = t_steps.with_grad(convert.from_jax(params))
    got = vqa_w.w_soft_loss(tp, tm, *_t(args), 0.7, deterministic=True)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-5)
    grads = torch.autograd.grad(got, tree_leaves(tp), allow_unused=True)
    _assert_leaves_close(_grads_to_jax(tp, grads), want_g, 1e-4)
    n_vgg = len(tree_leaves(tp["vgg"]))
    assert all(g is None for g in grads[:n_vgg])
    assert all(float(jnp.abs(g).max()) == 0.0
               for g in jax.tree_util.tree_leaves(want_g["vgg"]))
    # w_loss is the real-pair term alone
    torch.testing.assert_close(
        vqa_w.w_loss(tp, tm, *_t(args[:3]), deterministic=True),
        losses.cross_entropy(vqa_w.w_forward(tp, tm, *_t(args[:2])),
                             torch.from_numpy(args[2])))


def test_generate_gradient_flow_property():
    """The reference's property: generated tokens carry no gradient, so a
    loss on the generated answers gives EF's question head `qst.fc2`
    exactly zero, while `qst.fc1` and the answer head `fc1` get some."""
    _, t_cfg = _cfgs()
    tm = t_cfg.model
    gen = torch.Generator().manual_seed(4)
    params, arch = vqa_ef.init_ef_model(gen, tm)
    tp = t_steps.with_grad(params)
    img = torch.from_numpy(_image(tm, b=4))
    target = torch.softmax(torch.randn(4, tm.ans_vocab_size, generator=gen),
                           -1)
    for sample in (True, False):
        qst, pseudo_ans = vqa_ef.ef_generate(
            tp, arch, tm, img, sample_deterministic=sample,
            sample_gen=torch.Generator().manual_seed(5))
        assert not qst.requires_grad and qst.dtype == torch.int32
        grads = dict(zip(
            ("qst.fc2.w", "qst.fc2.b", "qst.fc1.w", "fc1.w"),
            torch.autograd.grad(
                losses.soft_xent(pseudo_ans, target),
                [tp["qst"]["fc2"]["w"], tp["qst"]["fc2"]["b"],
                 tp["qst"]["fc1"]["w"], tp["fc1"]["w"]], allow_unused=True)))
        assert grads["qst.fc2.w"] is None and grads["qst.fc2.b"] is None
        assert float(grads["qst.fc1.w"].abs().sum()) > 0
        assert float(grads["fc1.w"].abs().sum()) > 0


def test_sampling_branch_of_generate():
    """Tokens drawn from softmax(logits / temperature) with the sampling
    generator: reproducible from its seed, different for another seed at
    a high temperature, and the greedy tokens as the temperature goes to
    0. Sampling without a generator raises."""
    _, t_cfg = _cfgs()
    tm = t_cfg.model
    gen = torch.Generator().manual_seed(6)
    params, _ = vqa_ef.init_ef_model(gen, tm)
    emb = torch.nn.functional.normalize(
        torch.randn(B, tm.img_embed_size, generator=gen))
    greedy = ef_qst_generate(params["qst"], emb, tm.max_qst_len)

    def sample(seed, temperature):
        return ef_qst_generate(
            params["qst"], emb, tm.max_qst_len, deterministic=False,
            sample_gen=torch.Generator().manual_seed(seed),
            temperature=temperature)

    a, b, c = sample(1, 5.0), sample(1, 5.0), sample(2, 5.0)
    assert a.shape == (B, tm.max_qst_len) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < tm.qst_vocab_size
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, greedy)
    assert torch.equal(sample(3, 1e-4), greedy)
    with pytest.raises(ValueError, match="generator"):
        ef_qst_generate(params["qst"], emb, tm.max_qst_len,
                        deterministic=False)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _opt_trees():
    rng = np.random.default_rng(7)
    params = {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32)},
              "b": [rng.standard_normal(4).astype(np.float32),
                    rng.standard_normal((2, 2)).astype(np.float32)]}
    # a small step, one that the clip at 5 scales down, one with a leaf
    # whose gradient is None in the port and zero in JAX
    scales = (0.1, 40.0, 1.0)
    grads = [jax.tree_util.tree_map(
        lambda p: (s * rng.standard_normal(p.shape)).astype(np.float32),
        params) for s in scales]
    return params, grads


@pytest.mark.parametrize("which", ["model", "arch"])
def test_optimizer_matches_optax_on_given_gradients(which):
    """Three steps on identical given gradients, one of them clipped, with
    the learning rate changed before the third: params within 1e-6,
    moments within 1e-6 of their scale, after every step."""
    tcfg_j, tcfg_t = j_small_config().train, small_test_config().train
    j_tx = (j_optim.model_optimizer if which == "model"
            else j_optim.arch_optimizer)(tcfg_j)
    t_tx = (t_optim.model_optimizer if which == "model"
            else t_optim.arch_optimizer)(tcfg_t)
    params, grads = _opt_trees()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = j_tx.init(jp)
    tp, ts = _t(params), None
    ts = t_tx.init(tp)
    for step, g in enumerate(grads):
        if step == 2 and which == "model":
            js = j_optim.set_learning_rate(js, 3e-4)
            ts = t_optim.set_learning_rate(ts, 3e-4)
        norm = float(optax.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                              g)))
        assert (norm > tcfg_j.grad_clip) == (step == 1)
        tg = tree_leaves(_t(g))
        if step == 2:
            g = dict(g, a={"w": np.zeros_like(g["a"]["w"])})
            tg[0] = None
        upd, js = j_tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        before = [p.clone() for p in tree_leaves(tp)]
        tp, ts = t_tx.update(tp, tg, ts)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        assert ts["step"] == step + 1
        assert all(not torch.equal(a, b)
                   for a, b in zip(before, tree_leaves(tp)))
    # the state maps onto optax's, leaf for leaf
    back = convert.opt_state_from_jax(js, lr=tcfg_j.arch_learning_rate)
    assert back["step"] == 3
    np.testing.assert_allclose(back["lr"], ts["lr"], rtol=1e-6)
    for k in ("m", "v"):
        for a, b in zip(tree_leaves(ts[k]), tree_leaves(back[k])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-9)


def test_frozen_leaves_do_not_move_and_keep_zero_moments():
    """A leaf whose gradient is None (the detached VGG trunk) is left bit
    for bit where it was, with an Adam state of zeros."""
    tx = t_optim.model_optimizer(small_test_config().train)
    params = {"vgg": {"w": torch.randn(3, 3)}, "fc": {"w": torch.randn(3)}}
    state = tx.init(params)
    for _ in range(3):
        new, state = tx.update(params, [None, torch.randn(3)], state)
        assert torch.equal(new["vgg"]["w"], params["vgg"]["w"])
        assert not torch.equal(new["fc"]["w"], params["fc"]["w"])
        params = new
    assert float(state["m"]["vgg"]["w"].abs().max()) == 0.0
    assert float(state["v"]["vgg"]["w"].abs().max()) == 0.0


def test_step_lr():
    for epoch in (0, 9, 10, 25):
        assert t_optim.step_lr(1e-3, epoch, 10, 0.1) == pytest.approx(
            j_optim.step_lr(1e-3, epoch, 10, 0.1))


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def test_darts_stage1_matches_jax_over_three_steps():
    """stage1 of the darts EF with dropout_rate = 0 (no randomness left in
    it): the loss and both counters of three successive steps on three
    batches. First loss within 1e-5; later ones within 2e-3: they are
    taken after Adam steps whose first update, lr * sign(g) nearly, turns
    rounding noise in a tiny gradient into a full step of that weight."""
    j_cfg, t_cfg = _cfgs(dropout_rate=0.0)
    jm = j_cfg.model
    params, arch = j_ef.init_ef_model(jax.random.PRNGKey(8), jm)
    js = j_steps.make_lct_steps(j_cfg, unk_idx=1)
    ts = t_steps.make_lct_steps(t_cfg, 1, "cpu")
    j_opt = js["ef_tx"].init(params)
    tp, ta = convert.from_jax(params), convert.from_jax(arch)
    t_opt = ts["ef_tx"].init(tp)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        batch = _batch(jm, seed=10 + i)
        params, j_opt, want, wc1, wc2 = js["stage1"](
            params, arch, j_opt, batch, jax.random.PRNGKey(i))
        tp, t_opt, got, c1, c2 = ts["stage1"](tp, ta, t_opt, _t(batch), gen)
        assert got.dim() == 0 and c1.dim() == 0 and not got.requires_grad
        tol = 1e-5 if i == 0 else 2e-3
        np.testing.assert_allclose(float(got), float(want), rtol=tol,
                                   atol=tol)
        assert (int(c1), int(c2)) == (int(wc1), int(wc2))
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        ts["stage3"]()


def test_stage2_with_given_pseudo_questions_matches_jax_loss():
    """Sampling cannot be compared across frameworks, and W's VGG has a
    hard-coded dropout: the stage-2 loss is compared through w_soft_loss
    (above). Here stage2 itself runs: finite loss, a count between 0 and
    2B, W's frozen trunk unmoved, its heads moved."""
    _, t_cfg = _cfgs(img_size=32)
    tm = t_cfg.model
    gen = torch.Generator().manual_seed(9)
    ef_params, arch = vqa_ef.init_ef_model(gen, tm)
    w_params = vqa_w.init_w_model(gen, tm)
    ts = t_steps.make_lct_steps(t_cfg, 1, "cpu")
    w_opt = ts["w_tx"].init(w_params)
    new, w_opt, loss, corr = ts["stage2"](
        w_params, w_opt, ef_params, arch, _t(_batch(tm)), gen,
        torch.Generator().manual_seed(10))
    assert np.isfinite(float(loss)) and 0 <= int(corr) <= 2 * B
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new["vgg"]),
                                                 tree_leaves(w_params["vgg"])))
    assert not torch.equal(new["fc2"]["w"], w_params["fc2"]["w"])
    assert w_opt["step"] == 1


def test_eval_step_matches_jax():
    """eval: loss within 1e-5, counters and greedy questions equal."""
    j_cfg, t_cfg = _cfgs()
    jm = j_cfg.model
    params, arch = j_ef.init_ef_model(jax.random.PRNGKey(11), jm)
    batch = _batch(jm, seed=12)
    want = j_steps.make_lct_steps(j_cfg, unk_idx=1)["eval"](
        params, arch, batch, jax.random.PRNGKey(0))
    got = t_steps.make_lct_steps(t_cfg, 1, "cpu")["eval"](
        convert.from_jax(params), convert.from_jax(arch), _t(batch))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5,
                               atol=1e-5)
    assert (int(got[1]), int(got[2])) == (int(want[1]), int(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# running BatchNorm statistics
# ---------------------------------------------------------------------------

def test_running_stats_match_torch_batchnorm_and_jax():
    """capture -> update -> eval against torch.nn.BatchNorm2d (the values
    tests/test_bn_running.py holds the JAX package to) and against the
    JAX package itself, within 1e-5."""
    rng = np.random.RandomState(0)
    ch = 3
    batches = [rng.randn(4, 5, 5, ch).astype(np.float32) for _ in range(3)]
    x_eval = rng.randn(4, 5, 5, ch).astype(np.float32)
    bn = torch.nn.BatchNorm2d(ch, affine=False).train()
    for x in batches:
        bn(torch.tensor(x).permute(0, 3, 1, 2))
    bn.eval()
    torch_eval = bn(torch.tensor(x_eval).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1)

    running = j_running = None
    for x in batches:
        with t_conv.bn_capture() as cap:
            ours = t_conv.batchnorm({}, torch.from_numpy(x))
        with j_conv.bn_capture() as j_cap:
            theirs = j_conv.batchnorm({}, jnp.asarray(x))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-5, atol=1e-5)
        if running is None:
            running = t_conv.init_running_stats(cap.stats)
            j_running = j_conv.init_running_stats(j_cap.stats)
            assert float(running[0]["var"].min()) == 1.0
        running = t_conv.update_running_stats(running, cap.stats)
        j_running = j_conv.update_running_stats(j_running, j_cap.stats)
    for k, ref in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(running[0][k].numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(running[0][k].numpy(),
                                   np.asarray(j_running[0][k]), rtol=1e-5,
                                   atol=1e-6)
    with t_conv.bn_eval(running):
        ours_eval = t_conv.batchnorm({}, torch.from_numpy(x_eval))
    np.testing.assert_allclose(ours_eval.numpy(), torch_eval.numpy(),
                               rtol=1e-5, atol=1e-5)
    # the lists convert as they are
    back = convert.from_jax(jax.tree_util.tree_map(np.asarray, j_running))
    np.testing.assert_allclose(back[0]["var"].numpy(),
                               running[0]["var"].numpy(), rtol=1e-5)


def test_bn_eval_count_mismatch_raises_and_contexts_skip_the_kernel():
    x = torch.ones(2, 3, 3, 2)
    with t_conv.bn_capture() as cap:
        t_conv.batchnorm({}, x)
    running = t_conv.init_running_stats(cap.stats)
    with pytest.raises(ValueError, match="consumed"):
        with t_conv.bn_eval(running):
            pass  # no call, one entry
    with pytest.raises(ValueError, match="ran out"):
        with t_conv.bn_eval(running):
            t_conv.batchnorm({}, x)
            t_conv.batchnorm({}, x)
    # under a context even a tensor off the CPU takes the plain path: a
    # meta tensor would make the kernel's wrapper raise
    was, t_conv.USE_PALLAS_BN = t_conv.USE_PALLAS_BN, True
    try:
        with t_conv.bn_capture():
            y = t_conv.batchnorm({}, torch.empty(2, 3, 3, 2, device="meta"))
        assert y.shape == (2, 3, 3, 2)
        with pytest.raises(ValueError, match="CUDA"):
            t_conv.batchnorm({}, torch.empty(2, 3, 3, 2, device="meta"))
    finally:
        t_conv.USE_PALLAS_BN = was


def test_lct_steps_with_bn_eval_stats_match_jax():
    """stage1 returns the captured statistics, bn_update keeps the running
    ones, eval consumes them twice: the same numbers as the JAX package's
    steps (captured statistics within 1e-4 of their scale, eval loss within
    1e-4)."""
    j_cfg, t_cfg = _cfgs(bn_eval_stats=True, dropout_rate=0.0)
    jm = j_cfg.model
    params, arch = j_ef.init_ef_model(jax.random.PRNGKey(13), jm)
    js = j_steps.make_lct_steps(j_cfg, unk_idx=1)
    ts = t_steps.make_lct_steps(t_cfg, 1, "cpu")
    batch = _batch(jm, seed=14)
    tp, ta = convert.from_jax(params), convert.from_jax(arch)
    *_, j_stats = js["stage1"](params, arch, js["ef_tx"].init(params), batch,
                               jax.random.PRNGKey(0))
    *_, t_stats = ts["stage1"](tp, ta, ts["ef_tx"].init(tp), _t(batch),
                               torch.Generator().manual_seed(0))
    assert len(t_stats) == len(j_stats) > 0
    _assert_leaves_close(convert.to_jax(t_stats), j_stats, 1e-4, 1e-6)
    running = ts["bn_update"](ts["bn_update"](None, t_stats), t_stats)
    j_running = js["bn_update"](js["bn_update"](None, j_stats), j_stats)
    got = ts["eval"](tp, ta, _t(batch), running)
    want = js["eval"](params, arch, batch, jax.random.PRNGKey(0), j_running)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4,
                               atol=1e-4)
    assert got[3].shape == (B, jm.max_qst_len)
    plain = ts["eval"](tp, ta, _t(batch))
    assert abs(float(plain[0]) - float(got[0])) > 1e-6


# ---------------------------------------------------------------------------
# does it learn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def learn_setup():
    cfg = small_test_config()
    model = dataclasses.replace(
        cfg.model, img_embed_size=16, word_embed_size=8, lstm_hidden_size=16,
        max_qst_len=6, qst_vocab_size=32, ans_vocab_size=16, img_size=32,
        darts_layers=1, darts_steps=2, darts_multiplier=2,
        vgg_width_mult=1 / 16, vgg_fc_dim=32)
    cfg = cfg.replace(model=model, train=dataclasses.replace(
        cfg.train, learning_rate=3e-3, skip_stage3=True))
    return cfg, _t(_batch(model))


def test_stage1_overfits_one_batch(learn_setup):
    """The tests/test_convergence.py pattern: 100 stage-1 steps on one
    batch bring the loss under 0.7 of its start."""
    cfg, batch = learn_setup
    gen = torch.Generator().manual_seed(0)
    ef_params, arch = vqa_ef.init_ef_model(gen, cfg.model)
    steps = t_steps.make_lct_steps(cfg, 1, "cpu")
    ef_opt = steps["ef_tx"].init(ef_params)
    vals = []
    for _ in range(100):
        ef_params, ef_opt, loss, _, _ = steps["stage1"](
            ef_params, arch, ef_opt, batch, gen)
        vals.append(float(loss))
    assert np.isfinite(vals).all()
    assert vals[-1] < 0.7 * vals[0], (vals[0], vals[-1])


def test_stage2_w_model_improves(learn_setup):
    cfg, batch = learn_setup
    gen = torch.Generator().manual_seed(1)
    ef_params, arch = vqa_ef.init_ef_model(gen, cfg.model)
    w_params = vqa_w.init_w_model(gen, cfg.model)
    steps = t_steps.make_lct_steps(cfg, 1, "cpu")
    w_opt = steps["w_tx"].init(w_params)
    sample_gen = torch.Generator().manual_seed(2)
    vals = []
    for _ in range(100):
        w_params, w_opt, loss, _ = steps["stage2"](
            w_params, w_opt, ef_params, arch, batch, gen, sample_gen)
        vals.append(float(loss))
    assert np.isfinite(vals).all()
    assert np.mean(vals[-5:]) < 0.9 * np.mean(vals[:5]), (vals[:5],
                                                          vals[-5:])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_vqa_synth"))
    kw = dict(num_images=8, num_questions=24, img_size=32, n_answers=16)
    synthetic.make_dataset(d, **kw)
    return d, synthetic.make_arrays(**kw)


def test_dataset_gathers_as_the_jax_loader_does(synth):
    """The port's VqaH5Dataset on a make_dataset directory, the JAX
    package's on the same directory (numpy gather path) and the port's
    built from arrays in RAM give the same batches from the same rng."""
    from lctvqa.data import pipeline as j_pipeline

    d, arrays = synth
    ours = pipeline.get_loader(d, 8)
    theirs = j_pipeline.VqaH5Dataset(d, "train")
    ram = pipeline.loader_from_arrays(arrays)
    assert len(ours["train"]) == len(theirs) == len(ram["train"]) == 24
    idx = np.array([3, 0, 17, 9, 9, 23, 1, 12])
    a = ours["train"].gather(idx, np.random.default_rng(0))
    b = theirs.gather(idx, np.random.default_rng(0), use_native=False)
    c = ram["train"].gather(idx, np.random.default_rng(0))
    assert set(a) == set(b) == set(c)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    assert ours["train"].image_names(idx[:1]) == theirs.image_names(idx[:1])
    assert ours["valid"].split == "val"
    with pytest.raises(OSError):
        pipeline.get_loader(os.path.join(d, "missing"), 8)


def test_epoch_batches_and_prefetcher(synth):
    _, arrays = synth
    ds = pipeline.loader_from_arrays(arrays, train_portion=0.9)["train"]
    assert len(ds) == 21
    host = list(pipeline.epoch_batches(ds, 8, np.random.default_rng(1)))
    assert len(host) == 2  # the remainder is dropped
    got = list(pipeline.Prefetcher(
        pipeline.epoch_batches(ds, 8, np.random.default_rng(1)), "cpu"))
    assert len(got) == 2
    for h, g in zip(host, got):
        for k in pipeline.DEVICE_KEYS:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), h[k])
        assert isinstance(g["index"], np.ndarray)
    assert got[0]["image_u8"].dtype == torch.uint8
    seen = np.concatenate([g["index"] for g in got])
    assert len(set(seen.tolist())) == 16

    def broken():
        yield host[0]
        raise KeyError("worker failed")

    it = pipeline.Prefetcher(broken(), "cpu")
    next(it)
    with pytest.raises(KeyError, match="worker failed"):
        next(it)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_port_and_jax(tmp_path):
    """A checkpoint written by either package loads in the other through
    convert.py, exactly: params, arch, Adam states (step, learning rate,
    both moments), epoch."""
    j_cfg, t_cfg = _cfgs()
    jm = j_cfg.model
    params, arch = j_ef.init_ef_model(jax.random.PRNGKey(20), jm)
    js = j_steps.make_lct_steps(j_cfg, unk_idx=1)
    j_opt = js["ef_tx"].init(params)
    params, j_opt, *_ = js["stage1"](params, arch, j_opt, _batch(jm),
                                     jax.random.PRNGKey(0))
    j_opt = j_optim.set_learning_rate(j_opt, 2e-4)
    j_arch_opt = js["arch_tx"].init(arch)
    j_path = str(tmp_path / "jax.ckpt")
    j_ckpt.save_state(j_path, {"ef_params": params, "ef_opt": j_opt,
                               "arch": arch, "arch_opt": j_arch_opt,
                               "epoch": 3}, config=j_cfg)

    # JAX file -> the port
    state = convert.checkpoint_from_jax(
        checkpoint.load_state(j_path),
        arch_lr=t_cfg.train.arch_learning_rate)
    assert state["epoch"] == 3 and state["ef_opt"]["step"] == 1
    assert state["ef_opt"]["lr"] == pytest.approx(2e-4)
    assert state["arch_opt"]["step"] == 0
    assert state["config"]["model"]["img_embed_size"] == jm.img_embed_size
    for a, b in zip(tree_leaves(state["ef_params"]),
                    tree_leaves(convert.from_jax(params))):
        assert torch.equal(a, b)
    _, mu = [s for s in j_opt.inner_state[1]][0][:2]
    for a, b in zip(tree_leaves(state["ef_opt"]["m"]),
                    tree_leaves(convert.from_jax(mu))):
        assert torch.equal(a, b)

    # the port's file -> the port, bit for bit
    t_path = str(tmp_path / "torch.ckpt")
    checkpoint.save_state(t_path, state)
    again = checkpoint.load_state(t_path)
    assert again["epoch"] == 3 and again["ef_opt"]["step"] == 1
    for a, b in zip(tree_leaves(convert.as_tensors(again["ef_params"])),
                    tree_leaves(state["ef_params"])):
        assert torch.equal(a, b)

    # the port's file -> the JAX package: its own loader reads it, and
    # convert fills its optimizer's state
    loaded = j_ckpt.load_state(t_path)
    back = convert.checkpoint_to_jax(loaded, {
        "ef_opt": js["ef_tx"].init(params),
        "arch_opt": js["arch_tx"].init(arch)})
    for a, b in zip(jax.tree_util.tree_leaves(back["ef_params"]),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(back["arch"]),
                    jax.tree_util.tree_leaves(arch)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (jax.tree_util.tree_structure(back["ef_opt"])
            == jax.tree_util.tree_structure(j_opt))
    for a, b in zip(jax.tree_util.tree_leaves(back["ef_opt"]),
                    jax.tree_util.tree_leaves(j_opt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the JAX package steps on from it
    out = js["stage1"](back["ef_params"], back["arch"],
                       jax.tree_util.tree_map(jnp.asarray, back["ef_opt"]),
                       _batch(jm, seed=1), jax.random.PRNGKey(1))
    assert np.isfinite(float(out[2]))


def test_checkpoint_refuses_a_pickle(tmp_path):
    path = tmp_path / "legacy.ckpt"
    path.write_bytes(b"\\x80\\x04not a zip")
    with pytest.raises(ValueError, match="ZIP"):
        checkpoint.load_state(str(path))


# ---------------------------------------------------------------------------
# Experiment and the CLI
# ---------------------------------------------------------------------------

def _experiment_cfg(tmp_path, **model_kw):
    cfg = small_test_config()
    model = dataclasses.replace(
        cfg.model, img_embed_size=16, word_embed_size=8, lstm_hidden_size=16,
        max_qst_len=8, img_size=32, darts_layers=1, darts_steps=2,
        darts_multiplier=2, vgg_width_mult=1 / 16, vgg_fc_dim=32,
        qst_vocab_size=24, ans_vocab_size=16, **model_kw)
    return cfg.replace(
        model=model, root_stats_dir=str(tmp_path), exp_name="exp",
        train=dataclasses.replace(cfg.train, skip_stage3=True, batch_size=8,
                                  num_epochs=2, report_freq=1))


@pytest.mark.parametrize("flags", [{}, {"bn_eval_stats": True},
                                   {"pallas_mixed_op": True,
                                    "pallas_seq_lstm": True,
                                    "pallas_generate": True}],
                         ids=["default", "bn-running", "kernel-flags"])
def test_experiment_runs_saves_and_resumes(synth, tmp_path, flags):
    """Two epochs on in-RAM synthetic data: finite falling-or-flat
    metrics, both checkpoints written; a resumed Experiment starts at
    epoch 2 with the saved params and Adam states, and a fresh one in the
    same directory refuses to start."""
    _, arrays = synth
    cfg = _experiment_cfg(tmp_path, **flags)
    exp = Experiment(cfg, device="cpu",
                     data=pipeline.loader_from_arrays(arrays))
    exp.run()
    assert len(exp.train_ef_loss) == 2 and len(exp.val_ef_loss) == 3
    assert np.isfinite(exp.train_ef_loss + exp.train_w_loss
                       + exp.val_ef_loss).all()
    assert 0.0 <= exp.train_w_acc[-1] <= 1.0
    assert exp.ef_opt["step"] == exp.w_opt["step"] == 6
    assert exp.arch_opt["step"] == 0  # built and stored, never stepped
    for name in ("ef_model.ckpt", "w_model.ckpt", "log.txt"):
        assert (tmp_path / "exp" / name).exists()
    log = (tmp_path / "exp" / "log.txt").read_text()
    assert "genotype: Genotype(" in log and "| TIMING |" in log
    assert "generated qst:" in log and "BLEU" not in log

    with pytest.raises(RuntimeError, match="not empty"):
        Experiment(cfg, device="cpu",
                   data=pipeline.loader_from_arrays(arrays))
    again = Experiment(cfg.replace(resume=True), device="cpu",
                       data=pipeline.loader_from_arrays(arrays))
    assert again.current_epoch == 2 and again.ef_opt["step"] == 6
    for tree, other in ((again.ef_params, exp.ef_params),
                        (again.w_params, exp.w_params),
                        (again.arch, exp.arch),
                        (again.ef_opt["v"], exp.ef_opt["v"]),
                        (again.w_opt["m"], exp.w_opt["m"])):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tree),
                                                     tree_leaves(other)))
    if flags.get("bn_eval_stats"):
        assert len(again.bn_running) == len(exp.bn_running) > 0


def test_experiment_needs_a_card_unless_asked_for_the_cpu(synth, tmp_path):
    _, arrays = synth
    cfg = _experiment_cfg(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Experiment(cfg, data=pipeline.loader_from_arrays(arrays))
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        Experiment(cfg.replace(train=dataclasses.replace(
            cfg.train, skip_stage3=False)), device="cpu",
            data=pipeline.loader_from_arrays(arrays))


def test_epoch_lr_and_arch_update_freq(synth, tmp_path):
    _, arrays = synth
    exp = Experiment(_experiment_cfg(tmp_path), device="cpu",
                     data=pipeline.loader_from_arrays(arrays))
    exp.current_epoch = 12
    assert exp._epoch_lr() == pytest.approx(1e-4)
    exp.set_arch_update_freq()
    assert exp.arch_update_freq == 100  # 1 * 0.5^12 floors at the minimum


def test_cli_trains_one_epoch_on_the_cpu(synth, tmp_path):
    """`python -m lctvqa_torch.main --tiny --device cpu --skip_stage3` on a
    make_dataset directory: one epoch, both checkpoints, the log."""
    d, _ = synth
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "lctvqa_torch.main", "--tiny", "--device",
         "cpu", "--skip_stage3", "--input_dir", d, "--img_size", "32",
         "--batch_size", "8", "--num_epochs", "1", "--compute_dtype",
         "float32", "--exp", "cli"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = tmp_path / "experiment_data" / "cli"
    assert (out / "ef_model.ckpt").exists() and (out / "w_model.ckpt").exists()
    assert "| VALID SET | Epoch [01/01], Loss:" in (out / "log.txt").read_text()
    state = checkpoint.load_state(str(out / "ef_model.ckpt"))
    assert state["epoch"] == 1 and state["ef_opt"]["step"] == 3


@pytest.mark.parametrize("argv,match", [
    ([], "queue 1 item 3"),
    (["--skip_stage3", "--package", "darts"], "queue 1 item 5"),
    (["--skip_stage3", "--arch_type", "derived"], "Derived"),
    (["--skip_stage3", "--fuse_mixed_ops"], "Not ported"),
    (["--skip_stage3", "--remat_cells"], "Not ported"),
    (["--skip_stage3", "--pack_conv_branches"], "Not ported"),
    (["--skip_stage3", "--multihost"], "queue 1 item 7"),
    (["--skip_stage3", "--use_old_dataloader"], "queue 1 item 6")],
    ids=lambda v: "_".join(v).replace("--", "") if isinstance(v, list)
    else None)
def test_cli_flags_of_unported_paths_raise(argv, match):
    from lctvqa_torch import main as t_main

    with pytest.raises(NotImplementedError, match=match):
        t_main.main(argv + ["--input_dir", "/nonexistent"])
    args = t_main.build_parser().parse_args([])
    assert args.device == "cuda" and not args.skip_stage3
