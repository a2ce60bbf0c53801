"""The port's DARTS family against the JAX package on the CPU: the npy
loaders (data/pipeline_npy.py), the vocabulary builders (data/vocab.py),
the unified metrics, DartsExperiment (train/experiment_darts.py) for one
tiny epoch with its checkpoints, guard and resume, the interchange of
its checkpoints with the JAX package's DartsExperiment, and the CLI of
the new paths. The loop's steps are in tests/test_torch_darts_steps.py;
the unified model, its steps, experiment and serving in
tests/test_torch_unified.py.

fp32 at the micro sizes of tests/test_torch_architect.py (a supernet of
one reduction cell of two nodes) on 16-pixel images; data from the JAX
package's `make_dataset` directory (conftest's synth_dir). No JAX step
runs here: nothing is compiled but the JAX package's eager init.
"""

import dataclasses
import filecmp
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lctvqa.config import (Config as JConfig, DataConfig as JDataConfig,
                           ModelConfig as JModelConfig,
                           TrainConfig as JTrainConfig)
from lctvqa.data import pipeline_npy as j_npy
from lctvqa.optim import optimizers as j_optim
from lctvqa.text import VocabDict as JVocab
from lctvqa.train import checkpoint as j_ckpt, metrics as j_metrics
from lctvqa.train.experiment_darts import DartsExperiment as JDarts
from lctvqa_torch import convert
from lctvqa_torch.config import (Config, DataConfig, ModelConfig,
                                 TrainConfig)
from lctvqa_torch.data import pipeline_npy, synthetic, vocab
from lctvqa_torch.optim.optimizers import tree_map
from lctvqa_torch.text import VocabDict
from lctvqa_torch.train import checkpoint, metrics
from lctvqa_torch.train.experiment_darts import DartsExperiment
from test_torch_train import REPO, one_cpu_thread  # noqa: F401 (autouse)

# the micro supernet of tests/test_torch_architect.py on the synthetic dataset's 16-pixel images
MODEL = dict(img_size=16, img_embed_size=16, word_embed_size=8,
             lstm_hidden_size=16, max_qst_len=12, darts_init_ch=4,
             darts_layers=1, darts_steps=2, darts_multiplier=2,
             compute_dtype="float32", dropout_rate=0.0)


# ---------------------------------------------------------------------------
# data: the npy loaders and the vocabularies
# ---------------------------------------------------------------------------

def _batches_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert type(a[k]) is type(b[k]), k
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("unified,route", [
    (False, "vectorized"), (False, "per-item"), (True, "per-item")])
def test_npy_batches_equal_jax(synth_dir, unified, route):
    """Two epochs of both splits from the same seed, shuffled and not:
    every batch equal to the JAX loader's (values, dtypes, containers),
    and the generator left in the same state. The vectorized route draws
    a batch's answers in one call, the per-item route one draw an item
    (it runs where the records' JPEGs exist; here it is forced)."""
    kw = dict(max_qst_length=12, img_size=16, unified=unified)
    want, got = (m.get_npy_loader(synth_dir, **kw) for m in (j_npy,
                                                              pipeline_npy))
    if route == "per-item":
        for ds in (*want.values(), *got.values()):
            ds._vectorizable = lambda: False
    r_want, r_got = np.random.default_rng(3), np.random.default_rng(3)
    n = 0
    for shuffle in (True, False):
        for split in ("train", "valid"):
            for a, b in zip(want[split].batches(5, r_want, shuffle),
                            got[split].batches(5, r_got, shuffle),
                            strict=True):
                _batches_equal(a, b)
                n += 1
    assert n == 16
    assert r_want.integers(1 << 30) == r_got.integers(1 << 30)


def test_npy_images_from_ram_equal_the_h5_route(synth_dir):
    """The in-RAM image table (split -> images, coco ids, as make_arrays
    gives them) yields the h5 route's batches."""
    import h5py

    with h5py.File(os.path.join(synth_dir, "images.h5"), "r") as fd:
        images = {s: {"images": fd[f"{s}/images"][()],
                      "coco_ids": fd[f"{s}/coco_ids"][()]} for s in fd}
    h5 = pipeline_npy.get_npy_loader(synth_dir, 12, img_size=16)
    ram = pipeline_npy.get_npy_loader(synth_dir, 12, img_size=16,
                                      images=images)
    for split in ("train", "valid"):
        for a, b in zip(h5[split].batches(8, np.random.default_rng(0)),
                        ram[split].batches(8, np.random.default_rng(0)),
                        strict=True):
            _batches_equal(a, b)


def test_vocab_files_equal_jax_bytes(synth_dir, tmp_path):
    """make_npy_records' vocab_unified.txt, and data/vocab.py's question
    and answer files from the same jsons, byte for byte the JAX
    package's make_dataset files for the same seed and sizes."""
    synthetic.make_npy_records(str(tmp_path), num_images=8, num_questions=24,
                               n_answers=16, seed=0)
    q, a = (str(tmp_path / d) for d in ("Questions", "Annotations"))
    vocab.make_vocab_questions(q, str(tmp_path / "vocab_questions.txt"))
    vocab.make_vocab_answers(a, str(tmp_path / "vocab_answers.txt"), 16)
    for name in ("vocab_unified.txt", "vocab_questions.txt",
                 "vocab_answers.txt"):
        assert filecmp.cmp(tmp_path / name, os.path.join(synth_dir, name),
                           shallow=False), name
    words = (tmp_path / "vocab_unified.txt").read_text().split("\n")
    assert words[:5] == ["<pad>", "<unk>", "<start>", "<end>", "<sep>"]


def test_unified_metrics_equal_jax(synth_dir):
    """extract_answer, unified_ans_acc and calc_bleu_scores_unified on
    seeded streams over the unified vocabulary (some with the reference
    answer between <sep> and <end>, some without a <sep>): equal
    exactly, BLEU4 being nltk's to the bit."""
    path = os.path.join(synth_dir, "vocab_unified.txt")
    tv, jv = VocabDict(path), JVocab(path)
    ts, js = (m.VqaStruct(synth_dir, "valid.npy") for m in (metrics,
                                                            j_metrics))
    names = list(js.img_to_qa)
    rng = np.random.default_rng(5)
    n, t = 24, 12
    qa = rng.integers(0, tv.vocab_size, (n, t)).astype(np.int32)
    for i in range(0, n, 2):  # a stream of a reference question and answer
        ref = js.get_ref_qa(names[i % len(names)])[0]
        ids = [2] + [tv.word2idx(w) for w in ref][:t - 3] + [3]
        qa[i, :len(ids)] = ids
    gt = qa.copy()
    gt[1::3] = rng.integers(0, tv.vocab_size, (len(gt[1::3]), t))
    for row in qa:
        assert metrics.extract_answer(row, tv) == j_metrics.extract_answer(
            row, jv)
    assert metrics.unified_ans_acc(gt, qa, tv) == j_metrics.unified_ans_acc(
        gt, qa, jv)
    img = [names[i % len(names)] for i in range(n)]
    assert ts.get_ref_qa(img[0]) == js.get_ref_qa(img[0])
    assert metrics.calc_bleu_scores_unified(img, qa, tv, ts) == \
        j_metrics.calc_bleu_scores_unified(img, qa, jv, js)


# ---------------------------------------------------------------------------
# DartsExperiment, its checkpoints, the CLI
# ---------------------------------------------------------------------------

def _exp_cfgs(synth_dir, root, name="exp", **train_kw):
    """(JAX config, port config) of a DartsExperiment on synth_dir."""
    qv, av = (JVocab(os.path.join(synth_dir, f)).vocab_size
              for f in ("vocab_questions.txt", "vocab_answers.txt"))
    model = dict(MODEL, qst_vocab_size=qv, ans_vocab_size=av)
    train = dict(dict(batch_size=8, num_epochs=1, arch_update_freq=2,
                      report_freq=1, architect_mode="exact"), **train_kw)
    return tuple(c(model=m(**model), train=t(**train),
                   data=d(input_dir=synth_dir), exp_name=name,
                   root_stats_dir=str(root))
                 for c, m, t, d in ((JConfig, JModelConfig, JTrainConfig,
                                     JDataConfig),
                                    (Config, ModelConfig, TrainConfig,
                                     DataConfig)))


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(v))
                           for v in jax.tree_util.tree_leaves(tree)])


def _trees_equal(a, b) -> bool:
    """Equal leaf for leaf, dicts matched by key (the JAX package's trees
    come back with their keys sorted)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_trees_equal, a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("qst_only", [False, True],
                         ids=["answer+question", "qst_only"])
def test_darts_experiment_epoch_checkpoints_and_resume(synth_dir, tmp_path,
                                                       qst_only):
    """One epoch (3 batches, arch steps at batches 0 and 2), validation,
    the three checkpoints and the log; a fresh experiment in the same
    directory refuses to start; a resumed one starts at epoch 1 with the
    params, arch, both Adam states and the statistics as saved, and runs
    its second epoch."""
    _, cfg = _exp_cfgs(synth_dir, tmp_path)
    exp = DartsExperiment(cfg, qst_only=qst_only, device="cpu")
    exp.run()
    assert exp.opt["step"] == 3 and exp.arch_opt["step"] == 2
    assert np.isfinite(exp.train_loss + exp.val_loss).all()
    assert 0.0 <= exp.val_acc[0] <= 1.0 and 0.0 <= exp.val_b4[0] <= 100.0
    d = tmp_path / "exp"
    for name in ("vqa_model.ckpt", "arch_par.ckpt", "stats.ckpt"):
        assert (d / name).exists(), name
    log = (d / "log.txt").read_text()
    assert log.count("| ARCH STEP | val-loss ") == 2
    assert log.count("| TRAIN | epoch 1 step ") == 3
    assert "| VAL | loss " in log and "genotype: Genotype(" in log
    assert "architect_mode exact: the exact DARTS architect" in log
    with pytest.raises(RuntimeError, match="not empty"):
        DartsExperiment(cfg, device="cpu")
    again = DartsExperiment(cfg.replace(
        resume=True, train=dataclasses.replace(cfg.train, num_epochs=2)),
        qst_only=qst_only, device="cpu")
    assert again.current_epoch == 1
    assert again.train_loss == exp.train_loss and again.val_b4 == exp.val_b4
    for a, b in ((again.params, exp.params), (again.arch, exp.arch),
                 (again.opt["m"], exp.opt["m"]),
                 (again.arch_opt["v"], exp.arch_opt["v"])):
        assert _trees_equal(a, b)
    assert again.opt["step"] == 3 and again.arch_opt["step"] == 2
    assert again.arch_opt["lr"] == exp.arch_opt["lr"]
    again.run()
    assert len(again.val_loss) == 2 and again.opt["step"] == 6
    state = checkpoint.load_state(str(d / "vqa_model.ckpt"))
    assert state["epoch"] == 2


def _random_opt(tree, seed, step, lr):
    """A port Adam state with random moments, as after `step` steps."""
    gen = torch.Generator().manual_seed(seed)
    rand = lambda t: torch.rand(t.shape, generator=gen)  # noqa: E731
    return {"step": step, "lr": lr, "m": tree_map(rand, tree),
            "v": tree_map(rand, tree)}


def test_port_resumes_the_jax_darts_checkpoints(synth_dir, tmp_path):
    """The JAX package's DartsExperiment writes vqa_model.ckpt,
    arch_par.ckpt and stats.ckpt (with Adam states of random moments,
    as after some steps; built here and converted, so that no JAX step
    runs): the port's DartsExperiment resumes them with params, arch,
    both Adam states (step, learning rate, moments) and statistics
    equal."""
    j_cfg, t_cfg = _exp_cfgs(synth_dir, tmp_path)
    jexp = JDarts(j_cfg, use_mesh=False)
    opt = _random_opt(convert.from_jax(jexp.params), 1, 7, 5e-4)
    arch_opt = _random_opt(convert.from_jax(jexp.arch), 2, 3, 6e-4)
    jexp.opt = convert.opt_state_to_jax(opt, jexp.opt)
    jexp.arch_opt = convert.opt_state_to_jax(arch_opt, jexp.arch_opt)
    jexp.current_epoch = 2
    jexp.train_loss, jexp.val_b4 = [2.5, 2.0, 1.5], [1.0, 2.0, 3.0]
    jexp.save_model()
    jexp.save_stats()
    texp = DartsExperiment(t_cfg.replace(resume=True), device="cpu")
    assert texp.current_epoch == 3 and texp.train_loss == [2.5, 2.0, 1.5]
    assert _trees_equal(texp.params, convert.from_jax(jexp.params))
    assert _trees_equal(texp.arch, convert.from_jax(jexp.arch))
    for got, want in ((texp.opt, opt), (texp.arch_opt, arch_opt)):
        assert (got["step"], got["lr"]) == (want["step"],
                                            pytest.approx(want["lr"]))
        assert _trees_equal(got["m"], want["m"])
        assert _trees_equal(got["v"], want["v"])


def test_jax_resumes_the_port_darts_checkpoints(synth_dir, tmp_path):
    """The port's DartsExperiment trains an epoch and writes its
    checkpoints; the JAX package's loader reads them, convert.
    checkpoint_to_jax gives its layout and optax states (the JAX
    optimizers' init as templates), and the JAX package's DartsExperiment
    resumes them with params, arch, Adam states and statistics equal."""
    j_cfg, t_cfg = _exp_cfgs(synth_dir, tmp_path / "port")
    texp = DartsExperiment(t_cfg, device="cpu")
    texp.run()
    j_cfg = j_cfg.replace(root_stats_dir=str(tmp_path / "jax"),
                          resume=True)
    os.makedirs(tmp_path / "jax" / "exp")
    params, arch = (convert.to_jax(t) for t in (texp.params, texp.arch))
    templates = {"opt": j_optim.model_optimizer(j_cfg.train).init(params),
                 "arch_opt": j_optim.arch_optimizer(j_cfg.train).init(arch)}
    for name in ("vqa_model.ckpt", "arch_par.ckpt", "stats.ckpt"):
        state = j_ckpt.load_state(str(tmp_path / "port" / "exp" / name))
        j_ckpt.save_state(str(tmp_path / "jax" / "exp" / name),
                          convert.checkpoint_to_jax(state, templates))
    jexp = JDarts(j_cfg, use_mesh=False)
    assert jexp.current_epoch == 1 and jexp.train_loss == texp.train_loss
    for got, want in ((jexp.params, params), (jexp.arch, arch)):
        np.testing.assert_array_equal(_flat(got), _flat(want))
    for got, want in ((jexp.opt, texp.opt), (jexp.arch_opt, texp.arch_opt)):
        back = convert.opt_state_from_jax(got, lr=want["lr"])
        assert back["step"] == want["step"]
        assert back["lr"] == pytest.approx(want["lr"])
        assert _trees_equal(back["m"], want["m"])


@pytest.fixture(scope="module")
def dataset32(tmp_path_factory):
    """The port's make_dataset at 32 pixels, which W's VGG19 needs: the
    h5 files and, beside them, the npy records and vocab_unified.txt."""
    d = str(tmp_path_factory.mktemp("npy32"))
    synthetic.make_dataset(d, num_images=8, num_questions=16, img_size=32)
    return d


@pytest.mark.parametrize("argv,log_line", [
    (["--package", "darts"], "| VAL | loss "),
    (["--package", "darts", "--qst_only"], "| VAL | loss "),
    (["--package", "unified"], " ans-acc "),
    (["--use_old_dataloader", "--skip_stage3"], "BLEU4: ")],
    ids=["darts", "darts-qst_only", "unified", "lct-npy"])
def test_cli_runs_the_new_paths_on_the_cpu(dataset32, tmp_path, argv,
                                           log_line):
    """`python -m lctvqa_torch.main --device cpu --tiny` with each new
    path, one epoch on the synthetic dataset (16 questions a split, two
    batches): exit 0, the validation line
    in the log and the family's checkpoints; the darts family's arch step
    runs (arch_update_freq 2)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "lctvqa_torch.main", "--tiny", "--device",
         "cpu", "--input_dir", dataset32, "--img_size", "32",
         "--batch_size", "8", "--num_epochs", "1", "--compute_dtype",
         "float32", "--arch_update_freq", "2", "--exp", "cli", *argv],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = tmp_path / "experiment_data" / "cli"
    log = (out / "log.txt").read_text()
    assert log_line in log
    darts = argv[0] == "--package"
    names = (("vqa_model.ckpt", "arch_par.ckpt", "stats.ckpt") if darts
             else ("ef_model.ckpt", "w_model.ckpt"))
    assert all((out / n).exists() for n in names)
    if darts:
        assert log.count("| ARCH STEP | val-loss ") == 1
        cfg = checkpoint.config_from_state(
            checkpoint.load_state(str(out / "vqa_model.ckpt")))
        want = VocabDict(os.path.join(
            dataset32, "vocab_unified.txt" if "unified" in argv
            else "vocab_questions.txt")).vocab_size
        assert cfg.model.qst_vocab_size == want
    else:
        cfg = checkpoint.config_from_state(
            checkpoint.load_state(str(out / "ef_model.ckpt")))
        assert cfg.data.use_old_dataloader
