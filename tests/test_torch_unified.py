"""The unified QA-stream model (lctvqa_torch/models/unified.py), its train
and eval steps, DartsExperimentUnified and a served unified artifact
against the JAX package on the CPU, in fp32 at the micro sizes of
tests/test_torch_architect.py: the supernet (one reduction cell of two
nodes) on 16-pixel images, VGG19 at 1/16 width on 32-pixel ones, batch
4, a vocabulary of 40 words.

Parameters are the JAX package's init, carried across with
`convert.from_jax`; inputs are numpy draws from a seed. Tolerances:
logits and losses within 1e-4 (tests/test_full_model_torch_parity.py);
each gradient leaf within 2e-3 of its own scale plus 1e-7, as the EF's
in tests/test_torch_train.py (the supernet's gradient goes through
batch-statistics BatchNorm, which amplifies the summation-order
difference of two fp32 implementations); greedy streams equal. Each
JAX reference is compiled once, with LLVM's optimizations off
(`jax_compiled`).
"""

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lctvqa.export import read_artifact as j_read_artifact
from lctvqa.models import unified as j_unified
from lctvqa.train.experiment_darts import make_unified_steps as j_steps
from lctvqa_torch import convert, serve
from lctvqa_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from lctvqa_torch.export import export_state, load_artifact, save_artifact
from lctvqa_torch.models import unified
from lctvqa_torch.optim.optimizers import tree_leaves
from lctvqa_torch.text import VocabDict
from lctvqa_torch.train import checkpoint
from lctvqa_torch.train.experiment_darts import (DartsExperimentUnified,
                                                 make_unified_steps)
from lctvqa_torch.train.steps import with_grad
from test_torch_architect import dropout_off, jax_compiled  # noqa: F401
from test_torch_darts import MODEL, _flat, _trees_equal
from test_torch_train import (_assert_leaves_close, _grads_to_jax, _t,
                              jax_ref, one_cpu_thread)  # noqa: F401
# (dropout_off, jax_ref and one_cpu_thread are fixtures, the last autouse)

B = 4
V = 40
ENCODERS = {"darts": dict(MODEL, qst_vocab_size=V),
            "fixed": dict(MODEL, qst_vocab_size=V, arch_type="fixed",
                          img_size=32, vgg_width_mult=1 / 16, vgg_fc_dim=32)}


def _cfgs(encoder="darts", **model_kw):
    from lctvqa.config import small_test_config as j_small_config
    from lctvqa_torch.config import small_test_config

    kw = dict(ENCODERS[encoder], **model_kw)
    return tuple(cfg.replace(model=dataclasses.replace(cfg.model, **kw))
                 for cfg in (j_small_config(), small_test_config()))


def _model(jm, seed=0):
    params, arch = j_unified.init_unified_model(jax.random.PRNGKey(seed), jm)
    if arch is not None:  # away from the uniform mixture
        rng = np.random.default_rng(seed + 1)
        arch = {k: jnp.asarray(rng.standard_normal(v.shape).astype(
            np.float32)) for k, v in arch.items()}
    return params, arch


def _batch(jm, seed=0):
    """uint8 images and streams that start with <start> and hold a <sep>
    and an <end>."""
    rng = np.random.default_rng(seed)
    qa = rng.integers(5, V, (B, jm.max_qst_len)).astype(np.int32)
    qa[:, 0], qa[:, 4], qa[:, 7], qa[:, 8:] = 2, 4, 3, 0
    return {"image_u8": rng.integers(0, 256, (B, jm.img_size, jm.img_size,
                                              3), dtype=np.uint8),
            "qa_str": qa}


def _image(jm, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, jm.img_size, jm.img_size, 3)).astype(np.float32)


def _port(tree):
    return None if tree is None else convert.from_jax(tree)


@pytest.mark.parametrize("encoder", ["darts", "fixed"])
def test_unified_forward_and_gradients_match_jax(encoder, jax_ref):
    """unified_forward's logits and unified_loss within 1e-4; the loss's
    gradient w.r.t. every param leaf (and arch leaf) within 2e-3 of its
    scale plus 1e-7 (the frozen VGG trunk gets none in either); greedy
    streams of unified_generate equal, with the port's kernel flags on
    (their plain versions on the CPU)."""
    j_cfg, t_cfg = _cfgs(encoder)
    jm, tm = j_cfg.model, t_cfg.model
    params, arch = _model(jm)
    img, qa = _image(jm), _batch(jm)["qa_str"]

    def j_loss(p, a):
        logits = j_unified.unified_forward(p, a, jm, img, qa)
        return j_unified.unified_loss(p, a, jm, img, qa), logits

    (want, want_logits), (want_p, want_a) = jax_compiled(
        jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True), params,
        arch)
    want_qa = jax_compiled(lambda p, a: j_unified.unified_generate(
        p, a, jm, img), params, arch)
    tp, ta = with_grad(_port(params)), (None if arch is None
                                        else with_grad(_port(arch)))
    timg, tqa = torch.from_numpy(img), torch.from_numpy(qa)
    logits = unified.unified_forward(tp, ta, tm, timg, tqa)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    got = unified.unified_loss(tp, ta, tm, timg, tqa)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    leaves = tree_leaves(tp) + tree_leaves(ta)
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    n = len(tree_leaves(tp))
    _assert_leaves_close(_grads_to_jax(tp, grads[:n]), want_p, 2e-3, 1e-7)
    if arch is not None:
        _assert_leaves_close(_grads_to_jax(ta, grads[n:]), want_a, 2e-3,
                             1e-7)
    else:
        assert all(g is None for g in grads[:len(tree_leaves(tp["vgg"]))])
    kernels = dataclasses.replace(tm, pallas_seq_lstm=True,
                                  pallas_generate=True)
    for cfg in (tm, kernels):
        with torch.no_grad():
            stream = unified.unified_generate(_port(params), _port(arch),
                                              cfg, timg)
        assert stream.dtype == torch.int32
        np.testing.assert_array_equal(stream.numpy(), np.asarray(want_qa))
    with torch.no_grad():
        again = unified.unified_forward(_port(params), _port(arch), kernels,
                                        timg, tqa)
    np.testing.assert_allclose(again.numpy(), logits.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_unified_init_shapes_and_encoders():
    """params["qa"] holds word2vec, lstm and an xavier fc2 with a zero
    bias over the unified vocabulary, no fc1 and no answer head; the
    supernet has an arch, VGG19 none; a derived encoder is refused."""
    for encoder, has_arch in (("darts", True), ("fixed", False)):
        tm = _cfgs(encoder)[1].model
        params, arch = unified.init_unified_model(torch.Generator(), tm)
        assert set(params["qa"]) == {"word2vec", "lstm", "fc2"}
        assert "fc1" not in params and "fc2" not in params
        assert params["qa"]["fc2"]["w"].shape == (tm.lstm_hidden_size, V)
        assert not params["qa"]["fc2"]["b"].any()
        assert (arch is not None) == has_arch
    with pytest.raises(ValueError, match="'darts'"):
        unified.init_unified_model(torch.Generator(), dataclasses.replace(
            tm, arch_type="derived"))


def test_unified_steps_match_jax():
    """One train step: the loss within 1e-5 relative, the new params
    within 1e-4 absolute and the argmax stream equal; one eval step: the
    loss within 1e-5 relative, the argmax and greedy streams equal. The
    supernet's model, which has no dropout."""
    j_cfg, t_cfg = _cfgs()
    jm = j_cfg.model
    params, arch = _model(jm, seed=2)
    batch = _batch(jm, seed=3)
    js = j_steps(j_cfg)
    want_p, _, want_loss, want_pred = jax_compiled(
        js["train"], params, js["tx"].init(params), arch, batch,
        jax.random.PRNGKey(0))
    ts = make_unified_steps(t_cfg)
    tp, ta = _port(params), _port(arch)
    got_p, got_opt, got_loss, got_pred = ts["train"](
        tp, ts["tx"].init(tp), ta, _t(batch), torch.Generator())
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    assert got_opt["step"] == 1
    np.testing.assert_array_equal(got_pred.numpy(), np.asarray(want_pred))
    np.testing.assert_allclose(_flat(convert.to_jax(got_p)), _flat(want_p),
                               rtol=0, atol=1e-4)
    want = jax_compiled(js["eval"], params, arch, batch,
                        jax.random.PRNGKey(0))
    got = ts["eval"](tp, ta, _t(batch))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# DartsExperimentUnified
# ---------------------------------------------------------------------------

def _exp_cfg(synth_dir, root, **train_kw):
    model = ModelConfig(**dict(MODEL, ans_vocab_size=VocabDict(os.path.join(
        synth_dir, "vocab_answers.txt")).vocab_size))
    train = TrainConfig(**dict(dict(batch_size=8, num_epochs=1,
                                    arch_update_freq=2, report_freq=1),
                               **train_kw))
    return Config(model=model, train=train, data=DataConfig(
        input_dir=synth_dir), exp_name="uni", root_stats_dir=str(root))


@pytest.fixture(scope="module")
def trained(synth_dir, tmp_path_factory):
    """DartsExperimentUnified after one epoch on synth_dir: (experiment,
    config)."""
    cfg = _exp_cfg(synth_dir, tmp_path_factory.mktemp("uni"))
    exp = DartsExperimentUnified(cfg, device="cpu")
    exp.run()
    return exp, cfg


def test_unified_experiment_epoch_checkpoints_and_resume(trained,
                                                         synth_dir):
    """One epoch (3 batches, the finite-difference arch step, the default
    mode, at batches 0 and 2), validation with the answer accuracy and
    BLEU4 in range, the three checkpoints, whose config carries the
    unified vocabulary's size; a fresh experiment in the same directory
    refuses to start, a resumed one reads everything back equal and runs
    on."""
    exp, cfg = trained
    v = VocabDict(os.path.join(synth_dir, "vocab_unified.txt")).vocab_size
    assert exp.cfg.model.qst_vocab_size == v
    assert exp.params["qa"]["fc2"]["w"].shape[1] == v
    assert exp.opt["step"] == 3 and exp.arch_opt["step"] == 2
    assert np.isfinite(exp.train_loss + exp.val_loss).all()
    assert 0.0 <= exp.train_acc[0] <= 1.0 and 0.0 <= exp.val_acc[0] <= 1.0
    assert 0.0 <= exp.val_b4[0] <= 100.0
    d = exp.exp_dir
    log = open(os.path.join(d, "log.txt")).read()
    assert log.count("| ARCH STEP | val-loss ") == 2
    assert " ans-acc " in log and "finite-difference DARTS architect" in log
    state = checkpoint.load_state(os.path.join(d, "vqa_model.ckpt"))
    assert checkpoint.config_from_state(state).model.qst_vocab_size == v
    assert os.path.exists(os.path.join(d, "stats.ckpt"))
    with pytest.raises(RuntimeError, match="not empty"):
        DartsExperimentUnified(cfg, device="cpu")
    again = DartsExperimentUnified(cfg.replace(resume=True, train=(
        dataclasses.replace(cfg.train, num_epochs=2))), device="cpu")
    assert again.current_epoch == 1 and again.train_acc == exp.train_acc
    for a, b in ((again.params, exp.params), (again.arch, exp.arch),
                 (again.opt["v"], exp.opt["v"]),
                 (again.arch_opt["m"], exp.arch_opt["m"])):
        assert _trees_equal(a, b)
    again.run()
    assert len(again.val_acc) == 2 and again.opt["step"] == 6


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_unified_artifact_served(trained, synth_dir, tmp_path):
    """export_state on the trained experiment's vqa_model.ckpt and
    arch_par.ckpt recognizes a unified model; the port's artifact is read
    by the JAX package as written; ServingModel.generate equals the JAX
    package's unified_generate on the params it reads from the artifact; generated_answers is the
    stream's words between <sep> and <end>; over HTTP /generate answers
    {"qa", "answer"} and /answer is a 400, with the kernel flags off and
    on (their plain versions on the CPU)."""
    exp, cfg = trained
    state = {**checkpoint.load_state(os.path.join(exp.exp_dir,
                                                  "vqa_model.ckpt")),
             **checkpoint.load_state(os.path.join(exp.exp_dir,
                                                  "arch_par.ckpt"))}
    art = export_state(state, exp.cfg.model, input_dir=synth_dir)
    assert art["meta"]["family"] == "unified"
    assert art["meta"]["epoch"] == state["epoch"]
    path = str(tmp_path / "unified.lctx")
    save_artifact(art, path)
    jart = j_read_artifact(path)
    assert jart["meta"]["family"] == "unified"
    u8 = np.random.default_rng(7).integers(0, 256, (8, 16, 16, 3),
                                           dtype=np.uint8)
    model = load_artifact(path, device="cpu", compute_dtype="float32")
    assert model.functions == ["generate"]
    assert model.config.qst_vocab_size == exp.cfg.model.qst_vocab_size
    got = model.generate(u8)
    jm = dataclasses.replace(_cfgs()[0].model,
                             qst_vocab_size=exp.cfg.model.qst_vocab_size,
                             ans_vocab_size=exp.cfg.model.ans_vocab_size)
    from lctvqa.data.pipeline import normalize_images
    want = jax_compiled(lambda p, a, x: j_unified.unified_generate(
        p, a, jm, normalize_images(x)), jart["params"]["params"],
        jart["params"]["arch"], u8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    words = art["meta"]["unified_words"]
    answers = model.generated_answers(u8)
    assert len(answers) == 8
    with pytest.raises(ValueError, match="answer_logits"):
        model.answer_logits(u8, np.zeros((8, 12), np.int32))
    for flags in ({}, {"pallas_seq_lstm": True, "pallas_generate": True}):
        srv = serve.make_server(path, port=0, window_ms=20.0, device="cpu",
                                compute_dtype="float32", **flags)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            port = srv.server_address[1]
            assert srv.RequestHandlerClass.service.warmup(max_batch=2) == 2
            status, body = _post(port, "/generate",
                                 {"image": u8[0].tolist()})
            assert status == 200 and set(body) == {"qa", "answer"}
            row = [words[int(i)] for i in got[0]]
            assert body["qa"] == " ".join(w for w in row if w != "<pad>")
            assert body["answer"] == answers[0]
            status, body = _post(port, "/answer", {"image": u8[0].tolist(),
                                                   "question": "what is"})
            assert status == 400 and "generate" in body["error"]
        finally:
            srv.shutdown()
            srv.server_close()
