"""HTTP serving with the port (lctvqa_torch/serve.py) over artifacts that
`lctvqa.export.save_artifact` wrote from JAX-initialised params.

Contract: /answer and /generate answer what the JAX package's
`w_forward`, `ef_forward` and `ef_generate` answer (argmaxes and greedy
tokens exact, fp32 on the CPU), for the fixed VGG19 encoder and for the
PC-DARTS supernet; a group is padded with repeats of its first row;
warmup covers every bucket the batcher can dispatch; either package reads
the artifact the other wrote; artifacts the port cannot serve raise; the
port never imports JAX.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lctvqa import __version__
from lctvqa.config import small_test_config
from lctvqa.data.pipeline import normalize_images
from lctvqa.export import save_artifact
from lctvqa.models import vqa_ef, vqa_w
from lctvqa.text import VocabDict
from lctvqa_torch import serve
from lctvqa_torch.export import load_artifact
from test_torch_train import one_cpu_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
MCFG = dataclasses.replace(small_test_config().model, arch_type="fixed",
                           img_size=32, compute_dtype="float32")
QST_WORDS = (["<pad>", "<unk>", "<start>", "<end>"]
             + [f"q{i}" for i in range(MCFG.qst_vocab_size - 4)])
ANS_WORDS = ["<unk>"] + [f"a{i}" for i in range(MCFG.ans_vocab_size - 1)]
QUESTIONS = ["what is q3 q17", "is the q5 q9 q1 q2 q8", "how many q40",
             "unknown words only"]


def _meta(family, **extra):
    """The meta keys lctvqa.export.export_state writes."""
    meta = {"artifact_version": 1, "family": family, "int8": False,
            "platforms": ["cpu"], "img_size": MCFG.img_size,
            "max_qst_len": MCFG.max_qst_len,
            "qst_vocab_size": MCFG.qst_vocab_size,
            "ans_vocab_size": MCFG.ans_vocab_size, "arch_type": "fixed",
            "epoch": None, "lctvqa_version": __version__,
            "qst_words": QST_WORDS, "ans_words": ANS_WORDS}
    meta.update(extra)
    return meta


def _write(path, params, meta):
    bundle = {"params": jax.tree_util.tree_map(np.asarray, params)}
    save_artifact({"exported": {}, "params": bundle, "meta": meta},
                  str(path))
    return str(path)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_srv")
    w = vqa_w.init_w_model(jax.random.PRNGKey(0), MCFG)
    ef, _ = vqa_ef.init_ef_model(jax.random.PRNGKey(1), MCFG)
    return {"w": (_write(d / "w.lctx", w, _meta("w")), w),
            "ef": (_write(d / "ef.lctx", ef, _meta("ef")), ef),
            "dir": d}


def _start(path, **kw):
    srv = serve.make_server(path, port=0, window_ms=20.0, device="cpu",
                            compute_dtype="float32", **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("flags", [{}, {"pallas_seq_lstm": True,
                                        "pallas_generate": True}],
                         ids=["default", "kernels"])
def test_endpoints_match_jax(artifacts, flags):
    rng = np.random.default_rng(0)
    n = len(QUESTIONS)
    u8 = rng.integers(0, 256, (n, MCFG.img_size, MCFG.img_size, 3),
                      dtype=np.uint8)
    img = normalize_images(jnp.asarray(u8))
    srv_w = _start(artifacts["w"][0], **flags)
    srv_ef = _start(artifacts["ef"][0], **flags)
    try:
        svc = srv_w.RequestHandlerClass.service
        qst = np.stack([svc._encode_question(q) for q in QUESTIONS])
        jobs = [(srv_w, "/answer", i) for i in range(n)]
        jobs += [(srv_ef, "/answer", i) for i in range(n)]
        jobs += [(srv_ef, "/generate", i) for i in range(n)]

        def ask(job):
            srv, path, i = job
            payload = {"image": u8[i].tolist()}
            if path == "/answer":
                payload["question"] = QUESTIONS[i]
            return _post(srv.server_address[1], path, payload)

        with ThreadPoolExecutor(len(jobs)) as pool:
            results = list(pool.map(ask, jobs))
        assert all(status == 200 for status, _ in results)

        w_ids = np.argmax(vqa_w.w_forward(artifacts["w"][1], MCFG, img,
                                          jnp.asarray(qst)), axis=1)
        ef_ids = np.argmax(vqa_ef.ef_forward(artifacts["ef"][1], None, MCFG,
                                             img, jnp.asarray(qst))[0],
                           axis=1)
        gen_tok, gen_ans = vqa_ef.ef_generate(artifacts["ef"][1], None, MCFG,
                                              img)
        qv = VocabDict(word_list=QST_WORDS)
        for i in range(n):
            assert results[i][1] == {"answer_id": int(w_ids[i]),
                                     "answer": ANS_WORDS[w_ids[i]]}
            assert results[n + i][1]["answer_id"] == int(ef_ids[i])
            gen = results[2 * n + i][1]
            assert gen["answer_id"] == int(np.argmax(gen_ans[i]))
            assert gen["question"] == qv.arr2qst(np.asarray(gen_tok[i]))
        # concurrent requests were fused into batched calls
        assert max(srv_ef.RequestHandlerClass.service.batcher.batch_sizes) > 1
    finally:
        srv_w.shutdown()
        srv_ef.shutdown()


def test_warmup_covers_every_dispatched_bucket(artifacts):
    """max_batch=48: the batcher pads a group of 33-48 requests to 64, so
    warmup must run 64 too (the JAX package's warmup stops at 32)."""
    srv = serve.make_server(artifacts["ef"][0], port=0, max_batch=48,
                            device="cpu", compute_dtype="float32")
    try:
        svc = srv.RequestHandlerClass.service
        seen = []
        for name in svc.model.functions:
            fn = getattr(svc.model, name)

            def spy(*args, fn=fn, name=name):
                seen.append((name, args[0].shape[0]))
                return fn(*args)

            setattr(svc.model, name, spy)
        assert svc.warmup() == 2 * 7
        dispatched = {serve.MicroBatcher.bucket(n) for n in range(1, 49)}
        for name in ("answer_logits", "generate"):
            warmed = {b for fn, b in seen if fn == name}
            assert warmed == {1, 2, 4, 8, 16, 32, 64}
            assert dispatched <= warmed
    finally:
        srv.server_close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_cast_at_load_change_no_result(artifacts, dtype):
    """ServingModel casts its weights for the compute dtype once, at load;
    its answers equal the model functions' on the artifact's own params,
    which cast them on every call."""
    from lctvqa_torch import convert
    from lctvqa_torch.data.pipeline import normalize_images as t_normalize
    from lctvqa_torch.export import read_artifact
    from lctvqa_torch.export import ServingModel
    from lctvqa_torch.models import vqa_ef as t_ef
    from lctvqa_torch.models import vqa_w as t_w

    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (2, MCFG.img_size, MCFG.img_size, 3),
                      dtype=np.uint8)
    qst = rng.integers(0, MCFG.qst_vocab_size, (2, MCFG.max_qst_len),
                       dtype=np.int32)
    img = t_normalize(torch.from_numpy(u8))
    flags = {"compute_dtype": dtype, "pallas_seq_lstm": True,
             "pallas_generate": True}
    for family in ("w", "ef"):
        art = read_artifact(artifacts[family][0])
        model = ServingModel(art, "cpu", **flags)
        raw = convert.from_jax(art["params"]["params"])
        if family == "w":
            want = t_w.w_forward(raw, model.config, img,
                                 torch.from_numpy(qst))
        else:
            want = t_ef.ef_forward(raw, None, model.config, img,
                                   torch.from_numpy(qst))[0]
            tok, ans = t_ef.ef_generate(raw, None, model.config, img)
            got_tok, got_ans = model.generate(u8)
            assert torch.equal(got_tok, tok)
            assert torch.equal(got_ans, torch.argmax(ans, dim=1))
        assert torch.equal(model.answer_logits(u8, qst), want)


def test_burst_of_connections_waits_for_accept(artifacts):
    """64 clients connect and send before the server accepts any of them:
    each connection must be queued by the listen backlog and answered.
    socketserver's default backlog of 5 queues 6; the rest are dropped or
    reset by the network stack."""
    import socket

    srv = serve.make_server(artifacts["w"][0], port=0, device="cpu",
                            compute_dtype="float32")
    conns, serving = [], False
    try:
        for _ in range(64):
            conns.append(socket.create_connection(srv.server_address,
                                                  timeout=10))
            conns[-1].sendall(b"GET /healthz HTTP/1.0\r\n\r\n")
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        serving = True
        for c in conns:
            head = c.makefile("rb").readline()
            assert head.split()[1] == b"200", head
    finally:
        for c in conns:
            c.close()
        if serving:  # shutdown() waits for a serve_forever loop to end
            srv.shutdown()
        srv.server_close()


def test_unservable_artifacts_raise(artifacts, monkeypatch):
    d = artifacts["dir"]
    ef = artifacts["ef"][1]
    derived = dict(ef, derived=ef["vgg"])
    for name, params, meta, exc, match in (
            ("derived", derived, _meta("ef", arch_type="derived"),
             ValueError, "needs genotype"),
            ("mismatch", ef, _meta("ef", arch_type="darts"), ValueError,
             "arch_type"),
            ("int8", artifacts["w"][1], _meta("w", int8=True),
             NotImplementedError, "int8")):
        path = _write(d / f"{name}.lctx", params, meta)
        with pytest.raises(exc, match=match):
            load_artifact(path, device="cpu")
    # no silent fall back to the CPU when the GPU is missing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_artifact(artifacts["w"][0])


# ---------------------------------------------------------------------------
# the PC-DARTS supernet EF
# ---------------------------------------------------------------------------

DARTS = dataclasses.replace(small_test_config().model, arch_type="darts",
                            compute_dtype="float32")
NODE_FLAGS = [{}, {"pallas_mixed_op": True}]


@pytest.fixture(scope="module")
def darts_artifact(tmp_path_factory):
    """A small darts EF artifact as lctvqa.export writes it: params and
    arch in one bundle. The arch parameters are moved off their 1e-3 init
    so that the mixture is not uniform."""
    params, arch = vqa_ef.init_ef_model(jax.random.PRNGKey(2), DARTS)
    rng = np.random.default_rng(3)
    arch = {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in arch.items()}
    bundle = {"params": jax.tree_util.tree_map(np.asarray, params),
              "arch": arch}
    path = tmp_path_factory.mktemp("torch_darts") / "ef_darts.lctx"
    meta = _meta("ef", arch_type="darts", img_size=DARTS.img_size)
    save_artifact({"exported": {}, "params": bundle, "meta": meta}, str(path))
    return str(path), bundle


def _darts_inputs(n, seed=4):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (n, DARTS.img_size, DARTS.img_size, 3),
                      dtype=np.uint8)
    qst = rng.integers(0, DARTS.qst_vocab_size, (n, DARTS.max_qst_len),
                       dtype=np.int32)
    return u8, qst


def test_darts_dims_come_from_the_param_shapes(darts_artifact):
    model = load_artifact(darts_artifact[0], device="cpu")
    for field in ("arch_type", "darts_init_ch", "darts_layers", "darts_steps",
                  "darts_multiplier", "darts_stem_multiplier",
                  "darts_partial_k", "img_embed_size", "lstm_hidden_size",
                  "qst_vocab_size", "ans_vocab_size", "img_size"):
        assert getattr(model.config, field) == getattr(DARTS, field), field
    assert model.functions == ["answer_logits", "generate"]


@pytest.mark.parametrize("flags", NODE_FLAGS, ids=["default", "node_kernel"])
def test_darts_endpoints_match_jax(darts_artifact, flags):
    """Requests sent one at a time, so that each is a dispatch group of
    its own: the answer is the JAX package's on that batch of one."""
    path, bundle = darts_artifact
    u8, _ = _darts_inputs(2)
    srv = _start(path, **flags)
    try:
        svc = srv.RequestHandlerClass.service
        qv = VocabDict(word_list=QST_WORDS)
        for i in range(2):
            qst = svc._encode_question(QUESTIONS[i])[None]
            img = normalize_images(jnp.asarray(u8[i:i + 1]))
            status, ans = _post(srv.server_address[1], "/answer",
                                {"image": u8[i].tolist(),
                                 "question": QUESTIONS[i]})
            assert status == 200
            want = vqa_ef.ef_forward(bundle["params"], bundle["arch"], DARTS,
                                     img, jnp.asarray(qst))[0]
            assert ans["answer_id"] == int(np.argmax(want[0]))
            status, gen = _post(srv.server_address[1], "/generate",
                                {"image": u8[i].tolist()})
            assert status == 200
            tok, gen_ans = vqa_ef.ef_generate(bundle["params"],
                                              bundle["arch"], DARTS, img)
            assert gen["answer_id"] == int(np.argmax(gen_ans[0]))
            assert gen["question"] == qv.arr2qst(np.asarray(tok[0]))
        assert svc.batcher.batch_sizes == [1, 1, 1, 1]
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("flags", NODE_FLAGS, ids=["default", "node_kernel"])
def test_darts_group_of_three_is_the_batch_of_four(darts_artifact, flags):
    """Batch-stat BatchNorm makes a row's answer depend on its group: a
    dispatch group of 3 gets the rows of the padded batch of 4 whose last
    row repeats the first, which is what the JAX package's batcher pads
    with, and not the rows of the unpadded batch of 3."""
    import threading as th

    path, bundle = darts_artifact
    model = load_artifact(path, device="cpu", compute_dtype="float32",
                          **flags)
    u8, qst = _darts_inputs(3, seed=5)
    batcher = serve.MicroBatcher(model, window_ms=1.0)
    group = [("answer_logits", (u8[i], qst[i]), th.Event(), {})
             for i in range(3)]
    batcher._dispatch("answer_logits", group)
    got = np.stack([g[3]["out"] for g in group])
    assert batcher.batch_sizes == [3]

    pad_u8 = np.concatenate([u8, u8[:1]])
    pad_qst = np.concatenate([qst, qst[:1]])
    padded = model.answer_logits(pad_u8, pad_qst).numpy()
    np.testing.assert_array_equal(got, padded[:3])
    np.testing.assert_array_equal(padded[3], padded[0])
    want = vqa_ef.ef_forward(bundle["params"], bundle["arch"], DARTS,
                             normalize_images(jnp.asarray(pad_u8)),
                             jnp.asarray(pad_qst))[0]
    np.testing.assert_allclose(got, np.asarray(want)[:3], rtol=1e-4,
                               atol=1e-4)
    # the unpadded batch of 3 answers differently, beyond the tolerance
    alone = model.answer_logits(u8, qst).numpy()
    assert np.abs(alone - got).max() > 2e-4


def test_artifacts_cross_between_the_packages(darts_artifact, tmp_path,
                                             monkeypatch):
    """lctvqa.export reads what the port's save_artifact wrote, and back:
    same tree structure (tuples and lists kept), dtypes and values; the
    two files are the same bytes when written at the same time (the ZIP
    entries carry the clock's time to two seconds, so both writes see one
    frozen clock)."""
    from lctvqa.export import read_artifact as jax_read
    from lctvqa_torch import export as t_export

    _, bundle = darts_artifact
    meta = _meta("ef", arch_type="darts")
    art = {"exported": {"answer_logits": b"\x00stablehlo\xff"},
           "params": dict(bundle, extra=(np.arange(3, dtype=np.int8),
                                         [np.float32(2.5)])),
           "meta": meta}
    assert t_export.ARTIFACT_VERSION == meta["artifact_version"]
    ported, jaxed = str(tmp_path / "port.lctx"), str(tmp_path / "jax.lctx")
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)
    t_export.save_artifact(art, ported)
    save_artifact(art, jaxed)
    monkeypatch.undo()
    for got in (jax_read(ported), t_export.read_artifact(jaxed),
                t_export.read_artifact(ported)):
        assert got["meta"] == meta and got["exported"] == art["exported"]
        assert (jax.tree_util.tree_structure(got["params"])
                == jax.tree_util.tree_structure(art["params"]))
        for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                        jax.tree_util.tree_leaves(art["params"])):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
    with open(ported, "rb") as f1, open(jaxed, "rb") as f2:
        assert f1.read() == f2.read()
    assert t_export.extract_answer_words(
        ["<start>", "q", "<sep>", "two", "cats", "<end>", "x"]) == "two cats"


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    offenders = [str(p) for p in (REPO / "lctvqa_torch").rglob("*.py")
                 if pattern.search(p.read_text())]
    offenders += [str(REPO / "chip_smoke.py")] if pattern.search(
        (REPO / "chip_smoke.py").read_text()) else []
    assert not offenders


def test_serving_imports_no_jax():
    code = """
import sys
import torch
from lctvqa_torch.config import ModelConfig
import lctvqa_torch.serve
from lctvqa_torch import convert
from lctvqa_torch.export import ServingModel
from lctvqa_torch.models import vqa_w
cfg = ModelConfig(img_embed_size=8, word_embed_size=4, lstm_hidden_size=8,
                  max_qst_len=5, qst_vocab_size=12, ans_vocab_size=6,
                  img_size=32, arch_type="fixed", compute_dtype="float32",
                  vgg_width_mult=0.0625, vgg_fc_dim=16)
params = vqa_w.init_w_model(torch.Generator().manual_seed(0), cfg)
meta = {"family": "w", "img_size": 32, "max_qst_len": 5}
model = ServingModel({"params": {"params": convert.to_jax(params)},
                      "meta": meta}, device="cpu", compute_dtype="float32")
out = model.answer_logits(torch.zeros(2, 32, 32, 3, dtype=torch.uint8),
                          torch.zeros(2, 5, dtype=torch.int32))
assert out.shape == (2, 6) and bool(torch.isfinite(out).all())
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
