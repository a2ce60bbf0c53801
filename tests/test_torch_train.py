"""The port's training slice (lctvqa_torch: losses, gradients, optimizer,
steps, running BatchNorm statistics, data, checkpoints, Experiment, CLI)
against the JAX package on the CPU, in fp32 at `small_test_config` sizes.

The same numpy-seeded inputs and the same parameters (initialised by the
JAX package, converted with lctvqa_torch.convert) go through both. The
supernet is the smallest that still goes through every code path of the
test config's: two reduction cells (the second after a reduction, so its
preprocess is the factorized one) of two nodes each, with stride-2 edges
on the eager path and a stride-1 edge on the node path. The JAX side of
a comparison is computed once per module (jitted) and shared by the cases
that need the same one. The steps, running statistics, data, checkpoints
and Experiment are in tests/test_torch_train_steps.py, on these helpers;
this file ends with two that train a tiny model to see it learn.
Tolerances are stated at each test; gradients are compared leaf by leaf,
relative to each leaf's own scale. Parameters after an Adam step are not
compared: from zero moments the first update is lr * g / (|g| + eps),
which keeps the sign of g and loses its size, so that two right
implementations differ by 100% on a leaf whose gradient is near eps.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lctvqa.config import small_test_config as j_small_config
from lctvqa.models import vqa_ef as j_ef, vqa_w as j_w
from lctvqa.ops import losses as j_losses
from lctvqa.optim import optimizers as j_optim
from lctvqa_torch import convert
from lctvqa_torch.config import small_test_config
from lctvqa_torch.models import vqa_ef, vqa_w
from lctvqa_torch.models.qst_encoder import ef_qst_generate
from lctvqa_torch.ops import losses
from lctvqa_torch.optim import optimizers as t_optim
from lctvqa_torch.optim.optimizers import tree_leaves, tree_map
from lctvqa_torch.train import steps as t_steps

REPO = Path(__file__).resolve().parents[1]
B = 8


# the supernet's nodes per cell and nodes concatenated at its output
SMALL_SUPERNET = {"darts_steps": 2, "darts_multiplier": 2}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """The tests of each port module that has this fixture (it is
    imported by the others) on one PyTorch intra-op thread, the count
    restored after: the suite runs several workers on the host's cores at
    once, and PyTorch's OpenMP threads spin when they outnumber the cores
    (the port's test files took three times as long without it)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _cfgs(**model_kw):
    """(JAX config, port config) of the same small model, stage 3 off."""
    out = []
    for make in (j_small_config, small_test_config):
        cfg = make()
        out.append(cfg.replace(
            model=dataclasses.replace(cfg.model,
                                      **{**SMALL_SUPERNET, **model_kw}),
            train=dataclasses.replace(cfg.train, skip_stage3=True)))
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """A memo of the JAX package's side of the comparisons, shared by the
    cases of this module that need the same one: ref(key, make) returns
    make()'s value, computed at the first call with that key."""
    memo = {}

    def ref(key, make):
        if key not in memo:
            memo[key] = make()
        return memo[key]

    return ref


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
def test_ef_loss_gradients_match_jax(arch_type, flags, jax_ref):
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

    # the node-kernel case shares the default case's JAX side (the JAX
    # package runs its default path for both)
    want, (want_p, want_a) = jax_ref(
        ("ef_loss", repr(jm)), lambda: jax.jit(jax.value_and_grad(
            j_loss, argnums=(0, 1)))(params, arch))
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
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: j_w.w_soft_loss(p, jm, *map(jnp.asarray, args), 0.7,
                                  deterministic=True)))(params)
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
    0. Sampling without a generator raises. (On the test config's own
    supernet: the question head's parameters are drawn after it, and these
    seeds leave no near tie for the low temperature.)"""
    _, t_cfg = _cfgs(darts_steps=4, darts_multiplier=4)
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
