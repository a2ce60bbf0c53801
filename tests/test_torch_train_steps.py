"""The port's training steps, running BatchNorm statistics, data,
checkpoints, Experiment and CLI against the JAX package on the CPU, in
fp32 at `small_test_config` sizes with the small supernet of
tests/test_torch_train.py, whose helpers these tests share (that file
has the losses, gradients and optimizer). Tolerances are stated at each
test.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lctvqa.models import vqa_ef as j_ef
from lctvqa.ops import conv as j_conv
from lctvqa.optim import optimizers as j_optim
from lctvqa.train import checkpoint as j_ckpt, steps as j_steps
from lctvqa_torch import convert
from lctvqa_torch.config import small_test_config
from lctvqa_torch.data import pipeline, synthetic
from lctvqa_torch.models import vqa_ef, vqa_w
from lctvqa_torch.ops import conv as t_conv
from lctvqa_torch.optim.optimizers import tree_leaves
from lctvqa_torch.train import checkpoint, steps as t_steps
from lctvqa_torch.train.experiment import Experiment
from test_torch_train import (B, REPO, _assert_leaves_close, _batch, _cfgs,
                              _t, jax_ref, one_cpu_thread)  # noqa: F401
# (jax_ref and one_cpu_thread are fixtures, the second autouse)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _jax_steps(jax_ref, j_cfg):
    """The JAX package's jitted LCT steps for j_cfg, built once per module
    so that cases on the same config share their compiled functions."""
    return jax_ref(("lct_steps", repr(j_cfg)),
                   lambda: j_steps.make_lct_steps(j_cfg, unk_idx=1))


def test_darts_stage1_matches_jax_over_three_steps(jax_ref):
    """stage1 of the darts EF with dropout_rate = 0 (no randomness left in
    it): the loss and both counters of three successive steps on three
    batches. First loss within 1e-5; later ones within 2e-3: they are
    taken after Adam steps whose first update, lr * sign(g) nearly, turns
    rounding noise in a tiny gradient into a full step of that weight."""
    j_cfg, t_cfg = _cfgs(dropout_rate=0.0)
    jm = j_cfg.model
    params, arch = j_ef.init_ef_model(jax.random.PRNGKey(8), jm)
    js = _jax_steps(jax_ref, j_cfg)
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
    # stage 3 runs (W's VGG19 needs 32 pixels): a finite W'-val loss, a
    # changed arch and a stepped arch optimizer (tests/test_torch_
    # architect*.py hold it against the JAX package)
    _, t32 = _cfgs(img_size=32)
    ts = t_steps.make_lct_steps(t32, 1, "cpu")
    gen = torch.Generator().manual_seed(1)
    ef_params, arch = vqa_ef.init_ef_model(gen, t32.model)
    w_params = vqa_w.init_w_model(gen, t32.model)
    arch_opt = ts["arch_tx"].init(arch)
    new, arch_opt, loss = ts["stage3"](
        arch, arch_opt, ef_params, w_params, _t(_batch(t32.model, seed=1)),
        _t(_batch(t32.model, seed=2)), 1e-3, 1e-3, gen)
    assert loss.dim() == 0 and np.isfinite(float(loss))
    assert arch_opt["step"] == 1
    assert all(torch.isfinite(a).all() and not torch.equal(a, b)
               for a, b in zip(tree_leaves(new), tree_leaves(arch)))


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


def test_eval_step_matches_jax(jax_ref):
    """eval: loss within 1e-5, counters and greedy questions equal."""
    j_cfg, t_cfg = _cfgs(dropout_rate=0.0)
    jm = j_cfg.model
    params, arch = j_ef.init_ef_model(jax.random.PRNGKey(11), jm)
    batch = _batch(jm, seed=12)
    want = _jax_steps(jax_ref, j_cfg)["eval"](
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
# data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_vqa_synth"))
    kw = dict(num_images=8, num_questions=24, img_size=32, n_answers=16)
    synthetic.make_dataset(d, **kw)
    return d, synthetic.make_arrays(**kw)


def test_dataset_gathers_as_the_jax_loader_does(synth, monkeypatch):
    """The port's VqaH5Dataset on a make_dataset directory, the JAX
    package's on the same directory (numpy gather path) and the port's
    built from arrays in RAM give the same batches from the same rng. The
    JAX loader's native library is held off: its image gather would load
    it even on the numpy path, and tests/test_native.py may be rewriting
    it in another worker at that moment. The port's C++ core is held off
    the same way, so both take the numpy route (tests/test_torch_native.py
    holds the two cores' route to each other)."""
    from lctvqa import native as j_native
    from lctvqa.data import pipeline as j_pipeline
    from lctvqa_torch import native

    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)

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

def test_checkpoint_round_trip_port_and_jax(tmp_path, jax_ref):
    """A checkpoint written by either package loads in the other through
    convert.py, exactly: params, arch, Adam states (step, learning rate,
    both moments), epoch. (On the stage-1 test's config, whose compiled
    JAX steps it shares.)"""
    j_cfg, t_cfg = _cfgs(dropout_rate=0.0)
    jm = j_cfg.model
    params, arch = j_ef.init_ef_model(jax.random.PRNGKey(20), jm)
    js = _jax_steps(jax_ref, j_cfg)
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


def test_checkpoint_with_a_stepped_arch_opt_converts_both_ways(tmp_path):
    """An arch optimizer state that stage 3 has stepped (twice, by the JAX
    package's arch_tx on given gradients) converts from the JAX package's
    checkpoint to the port's and back exactly: step count and moments."""
    j_cfg, t_cfg = _cfgs()
    params, arch = j_ef.init_ef_model(jax.random.PRNGKey(21), j_cfg.model)
    arch_tx = j_optim.arch_optimizer(j_cfg.train)
    state = arch_tx.init(arch)
    rng = np.random.default_rng(22)
    for _ in range(2):
        g = jax.tree_util.tree_map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), arch)
        _, state = arch_tx.update(g, state, arch)
    j_path = str(tmp_path / "jax.ckpt")
    j_ckpt.save_state(j_path, {"arch": arch, "arch_opt": state, "epoch": 1},
                      config=j_cfg)
    port = convert.checkpoint_from_jax(
        checkpoint.load_state(j_path),
        arch_lr=t_cfg.train.arch_learning_rate)
    assert port["arch_opt"]["step"] == 2
    assert port["arch_opt"]["lr"] == pytest.approx(6e-4)
    t_path = str(tmp_path / "torch.ckpt")
    checkpoint.save_state(t_path, port)
    back = convert.checkpoint_to_jax(j_ckpt.load_state(t_path),
                                     {"arch_opt": arch_tx.init(arch)})
    assert (jax.tree_util.tree_structure(back["arch_opt"])
            == jax.tree_util.tree_structure(state))
    for a, b in zip(jax.tree_util.tree_leaves(back["arch_opt"]),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(np.asarray(back["arch_opt"][1].count)) == 2


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
    """Without a card the default device raises; on the CPU, asked for, an
    Experiment with stage 3 on builds and trains an epoch: stage 3 before
    every batch (arch_update_freq 1), its W'-val loss logged, the arch
    moved and its optimizer stepped once a batch."""
    _, arrays = synth
    cfg = _experiment_cfg(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Experiment(cfg, data=pipeline.loader_from_arrays(arrays))
    exp = Experiment(cfg.replace(train=dataclasses.replace(
        cfg.train, skip_stage3=False)), device="cpu",
        data=pipeline.loader_from_arrays(arrays))
    assert exp.cfg.train.stage3_remat and exp.arch_update_freq == 1
    arch = [a.clone() for a in tree_leaves(exp.arch)]
    exp.train_epoch()
    n_batches = len(exp.data["train"]) // cfg.train.batch_size
    assert exp.arch_opt["step"] == exp.ef_opt["step"] == n_batches
    assert all(torch.isfinite(b).all() and not torch.equal(a, b)
               for a, b in zip(arch, tree_leaves(exp.arch)))
    log = (tmp_path / "exp" / "log.txt").read_text()
    assert log.count("| TRAIN SET | STAGE3 | W'-Val-Loss: ") == n_batches
    assert "stage3:" in log  # the stage timer's line


def test_fixed_ef_has_no_arch_and_skips_stage3(synth, tmp_path):
    """The fixed VGG19 EF has no arch parameters: with stage 3 asked for,
    an epoch runs stages 1 and 2 alone, as in the JAX package."""
    _, arrays = synth
    cfg = _experiment_cfg(tmp_path, arch_type="fixed")
    exp = Experiment(cfg.replace(train=dataclasses.replace(
        cfg.train, skip_stage3=False)), device="cpu",
        data=pipeline.loader_from_arrays(arrays))
    assert exp.arch is None and exp.arch_opt is None
    exp.train_epoch()
    assert exp.ef_opt["step"] > 0
    assert "STAGE3" not in (tmp_path / "exp" / "log.txt").read_text()


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
    # one OpenMP thread, as this module's tests run (one_cpu_thread)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
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


def test_cli_runs_the_three_stages_on_the_cpu(synth, tmp_path):
    """`python -m lctvqa_torch.main --tiny --device cpu` without
    `--skip_stage3`: stage 3 before the first batch (the update frequency
    floors at 100), stages 1 and 2, validation; its log has the STAGE3
    line and its checkpoint a stepped arch optimizer, which `--resume`
    reads back. The resumed run takes the other architect flags."""
    d, _ = synth
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    argv = ["--tiny", "--device", "cpu", "--input_dir", d, "--img_size", "32",
            "--batch_size", "8", "--compute_dtype", "float32", "--exp", "s3"]
    proc = subprocess.run(
        [sys.executable, "-m", "lctvqa_torch.main", *argv, "--num_epochs",
         "1"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = tmp_path / "experiment_data" / "s3"
    log = (out / "log.txt").read_text()
    assert log.count("| TRAIN SET | STAGE3 | W'-Val-Loss: ") == 1
    assert "| VALID SET | Epoch [01/01], Loss:" in log
    assert "stage3_remat is forced on" not in log
    state = checkpoint.load_state(str(out / "ef_model.ckpt"))
    assert state["arch_opt"]["step"] == 1 and state["ef_opt"]["step"] == 3

    from lctvqa_torch import main as t_main
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        exp = t_main.main(argv + ["--resume", "--num_epochs", "2",
                                  "--architect_mode", "fd",
                                  "--no-stage3_remat"])
    finally:
        os.chdir(cwd)
    assert exp.cfg.train.architect_mode == "fd"
    assert not exp.cfg.train.stage3_remat
    assert exp.current_epoch == 1 and exp.arch_opt["step"] == 2
    assert log.count("STAGE3") < (out / "log.txt").read_text().count("STAGE3")


@pytest.mark.parametrize("argv,match", [
    (["--skip_stage3", "--fuse_mixed_ops"], "Not ported"),
    (["--skip_stage3", "--remat_cells"], "Not ported"),
    (["--skip_stage3", "--pack_conv_branches"], "Not ported"),
    (["--skip_stage3", "--pallas_mixed_op", "--device", "cpu",
      "--num_devices", "2"], "mixed-node kernels under data parallelism")],
    ids=lambda v: "_".join(v).replace("--", "") if isinstance(v, list)
    else None)
def test_cli_flags_of_unported_paths_raise(argv, match):
    from lctvqa_torch import main as t_main

    with pytest.raises(NotImplementedError, match=match):
        t_main.main(argv + ["--input_dir", "/nonexistent"])


def test_cli_derived_needs_a_genotype():
    """--arch_type derived runs since the derived net is ported; without
    --genotype it raises before any data is read, as the JAX package's
    assert does, and an unknown genotype names the presets."""
    from lctvqa_torch import main as t_main

    with pytest.raises(ValueError, match="needs genotype"):
        t_main.main(["--arch_type", "derived", "--input_dir", "/nonexistent"])
    with pytest.raises(ValueError, match="PC_DARTS_cifar"):
        t_main.main(["--arch_type", "derived", "--genotype", "NoSuchNet",
                     "--input_dir", "/nonexistent"])
    args = t_main.build_parser().parse_args([])
    assert args.device == "cuda" and not args.skip_stage3
