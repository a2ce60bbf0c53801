"""The port's decode-retrain-evaluate loop against the JAX package on the
CPU: genotype resolution (lctvqa_torch/genotype.py), the checkpoint
config both ways (train/checkpoint.py), BLEU4 and the npy records
(train/metrics.py, data/synthetic.py), validation's BLEU4, the eval CLI
(eval.py) and the derived retrain from the CLI, at the CLI's `--tiny`
sizes or `small_test_config`'s, fp32, on make_dataset's synthetic data
(32-pixel images: W's VGG19 needs them).

Exact where the same numbers go through the same arithmetic (decodes,
configs, records, BLEU4 of the same tokens, eval's accuracy and BLEU4 of
greedy tokens); logits within 1e-4 (tests/test_full_model_torch_parity.py).
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lctvqa import genotype as j_genotype
from lctvqa.config import small_test_config as j_small_config
from lctvqa.data import synthetic as j_synthetic
from lctvqa.models import genotypes as j_genotypes, search as j_search
from lctvqa.models import vqa_ef as j_ef
from lctvqa.optim import optimizers as j_optim
from lctvqa.text import VocabDict as JVocab
from lctvqa.train import checkpoint as j_ckpt, metrics as j_metrics
from lctvqa_torch import convert, eval as t_eval, genotype
from lctvqa_torch.config import Config, MeshConfig, small_test_config
from lctvqa_torch.data import pipeline, synthetic
from lctvqa_torch.models import genotypes, search, vqa_ef
from lctvqa_torch.text import VocabDict
from lctvqa_torch.train import checkpoint, metrics
from lctvqa_torch.train.experiment import Experiment
from test_torch_architect import jax_compiled
from test_torch_train import REPO, one_cpu_thread  # noqa: F401 (autouse)

# the supernet of the search checkpoints: 2 nodes a cell, so that a decode
# with the default 4 nodes would read past the arch
STEPS = {"darts_steps": 2, "darts_multiplier": 2}
# the --tiny model's dims (lctvqa_torch/main.py) on make_dataset's vocabs
TINY = dict(img_embed_size=16, word_embed_size=8, lstm_hidden_size=16,
            max_qst_len=8, darts_init_ch=4, darts_layers=1,
            vgg_width_mult=1 / 16, vgg_fc_dim=32, img_size=32,
            qst_vocab_size=24, ans_vocab_size=16, compute_dtype="float32")
DATA = dict(num_images=8, num_questions=16, img_size=32, n_answers=16)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_eval_synth"))
    synthetic.make_dataset(d, **DATA)
    return d


def _arch(seed=0):
    """Arch parameters of the 2-node supernet, away from the uniform
    mixture (numpy, the layout of both packages)."""
    rng = np.random.default_rng(seed)
    n = search.num_edges(STEPS["darts_steps"])
    return {k: rng.standard_normal(shape).astype(np.float32) for k, shape in (
        ("alphas_normal", (n, 8)), ("alphas_reduce", (n, 8)),
        ("betas_normal", (n,)), ("betas_reduce", (n,)))}


def _search_ckpts(tmp_path):
    """A search checkpoint of each package with the same arch: (port path,
    JAX path, arch)."""
    arch = _arch()
    t_cfg, j_cfg = small_test_config(), j_small_config()
    t_cfg = t_cfg.replace(model=dataclasses.replace(t_cfg.model, **STEPS))
    j_cfg = j_cfg.replace(model=dataclasses.replace(j_cfg.model, **STEPS))
    t_path, j_path = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    checkpoint.save_state(t_path, {"arch": convert.from_jax(arch),
                                   "epoch": 1}, config=t_cfg)
    j_ckpt.save_state(j_path, {"arch": jax.tree_util.tree_map(jnp.asarray,
                                                              arch),
                               "epoch": 1}, config=j_cfg)
    return t_path, j_path, arch


def test_genotype_decodes_and_resolves_across_packages(tmp_path):
    """A search checkpoint of either package decodes, in either package, to
    the JAX package's search.genotype of its arch at the steps and
    multiplier of its own config; resolve_genotype takes a preset, a repr
    file and a checkpoint of either package, and names the presets for
    anything else; the decode CLI prints and writes the repr."""
    t_path, j_path, arch = _search_ckpts(tmp_path)
    want = tuple(j_search.genotype(arch, **{
        "steps": STEPS["darts_steps"],
        "multiplier": STEPS["darts_multiplier"]}))
    assert tuple(search.genotype(arch, 2, 2)) == want
    for path in (t_path, j_path):
        got = genotype.genotype_from_checkpoint(path)
        assert isinstance(got, genotypes.Genotype) and tuple(got) == want
        assert tuple(genotype.resolve_genotype(path)) == want
        # the JAX package decodes the port's checkpoint (its loader reads
        # the port's config as its own Config)
        assert tuple(j_genotype.genotype_from_checkpoint(path)) == want

    assert genotype.resolve_genotype("AmoebaNet") is genotypes.AmoebaNet
    repr_file = tmp_path / "g.txt"
    repr_file.write_text(repr(j_genotypes.NASNet) + "\n")
    assert tuple(genotype.resolve_genotype(str(repr_file))) == tuple(
        j_genotypes.NASNet)
    with pytest.raises(ValueError, match="PC_DARTS_cifar"):
        genotype.resolve_genotype("NoSuchNet")
    with pytest.raises(ValueError, match="not a Genotype"):
        genotype.parse_genotype_repr("(1, 2)")
    with pytest.raises(NameError):  # no builtins reach the repr
        genotype.parse_genotype_repr("__import__('os')")
    no_arch = str(tmp_path / "w.ckpt")
    checkpoint.save_state(no_arch, {"arch": None, "epoch": 1})
    with pytest.raises(ValueError, match="no arch"):
        genotype.genotype_from_checkpoint(no_arch)

    out = tmp_path / "decoded.txt"
    genotype.main([t_path, "-o", str(out)])
    assert genotype.parse_genotype_repr(out.read_text()) == \
        genotype.genotype_from_checkpoint(t_path)



@pytest.mark.parametrize("cli", ["eval", "genotype"])
def test_cli_takes_trusted_and_still_refuses_a_pickle(cli, tmp_path, synth,
                                                      capsys):
    """--trusted, the JAX CLIs' flag for legacy pickle checkpoints
    (lctvqa/eval.py, lctvqa/genotype.py), is taken by the port's eval and
    genotype CLIs as by its export and serve CLIs. A pickle checkpoint is
    refused with it as without it: the port never unpickles a file.
    genotype decodes a ZIP checkpoint with the flag given."""
    exp = tmp_path / "exp" / "p"
    exp.mkdir(parents=True)
    legacy = exp / "ef_model.ckpt"
    with open(legacy, "wb") as f:
        pickle.dump({"epoch": 1, "arch": None}, f)
    if cli == "eval":
        run = t_eval.main
        argv = ["--exp", "p", "--root_stats_dir", str(tmp_path / "exp"),
                "--input_dir", synth, "--device", "cpu", "--num_show", "0",
                "--trusted"]
    else:
        run = genotype.main
        argv = [str(legacy), "--trusted"]
        t_path, _, _ = _search_ckpts(tmp_path)
        genotype.main([t_path, "--trusted"])
        assert capsys.readouterr().out.strip() == repr(
            genotype.genotype_from_checkpoint(t_path))
    with pytest.raises(ValueError, match="not a ZIP checkpoint"):
        run(argv)


def _derived_cfgs(name="PC_DARTS_cifar", **kw):
    """(JAX Config, port Config) of a derived EF at small_test_config
    dims."""
    out = []
    for make, presets in ((j_small_config, j_genotypes),
                          (small_test_config, genotypes)):
        g = getattr(presets, name)
        cfg = make()
        out.append(cfg.replace(exp_name="derived", model=dataclasses.replace(
            cfg.model, arch_type="derived", genotype=g,
            darts_steps=len(g.normal) // 2,
            darts_multiplier=len(g.normal_concat), **kw)))
    return out


def test_derived_checkpoint_config_moves_both_ways(tmp_path):
    """The port's derived checkpoint: the JAX loader reads its config as a
    JAX Config (fields equal, mesh at its default) whose genotype is the
    JAX package's Genotype, and its params, converted, give the JAX
    package's ef_forward the port's logits. The JAX package's derived
    checkpoint: config_from_state gives the port's Config, genotype and
    mesh included; an unknown field raises."""
    j_cfg, t_cfg = _derived_cfgs("AmoebaNet", darts_init_ch=4,
                                 darts_layers=2)
    params, _ = vqa_ef.init_ef_model(torch.Generator().manual_seed(0),
                                     t_cfg.model)
    t_path = str(tmp_path / "port.ckpt")
    checkpoint.save_state(t_path, {"ef_params": params, "arch": None,
                                   "epoch": 2}, config=t_cfg)
    loaded = j_ckpt.load_state(t_path)
    cfg = loaded["config"]
    assert type(cfg) is type(j_cfg) and type(cfg.model) is type(j_cfg.model)
    assert isinstance(cfg.model.genotype, j_genotypes.Genotype)
    assert tuple(cfg.model.genotype) == tuple(j_genotypes.AmoebaNet)
    assert cfg == j_cfg.replace(model=dataclasses.replace(
        j_cfg.model, genotype=cfg.model.genotype))
    assert j_ckpt.load_config(t_path) == cfg
    back = convert.checkpoint_to_jax(loaded, {})
    img = np.random.default_rng(1).standard_normal(
        (4, 16, 16, 3)).astype(np.float32)
    qst = np.random.default_rng(2).integers(
        0, t_cfg.model.qst_vocab_size, (4, t_cfg.model.max_qst_len)).astype(
            np.int32)
    want, _ = jax_compiled(
        lambda p, x, q: j_ef.ef_forward(p, None, cfg.model, x, q),
        back["ef_params"], jnp.asarray(img), jnp.asarray(qst))
    with torch.no_grad():
        got, _ = vqa_ef.ef_forward(params, None, t_cfg.model,
                                   torch.from_numpy(img),
                                   torch.from_numpy(qst))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)

    j_path = str(tmp_path / "jax.ckpt")
    j_ckpt.save_state(j_path, {"ef_params": back["ef_params"], "arch": None,
                               "epoch": 2}, config=j_cfg)
    state = checkpoint.load_state(j_path)
    assert isinstance(state["config"], dict) and "mesh" in state["config"]
    port_cfg = checkpoint.config_from_state(state)
    assert isinstance(port_cfg, Config)
    assert isinstance(port_cfg.model.genotype, genotypes.Genotype)
    assert port_cfg == t_cfg and isinstance(port_cfg.mesh, MeshConfig)
    assert checkpoint.config_from_state({"epoch": 1}) is None
    state["config"]["model"]["no_such_field"] = 1
    with pytest.raises(ValueError, match="no_such_field"):
        checkpoint.config_from_state(state)


def test_npy_records_and_bleu_match_jax(tmp_path, synth):
    """make_npy_records writes the JAX package's raw jsons and records for
    the same seed and sizes; VqaStruct reads the same references; BLEU4 is
    nltk's (through the JAX package's BLEU4) to the bit, and
    calc_bleu_scores the JAX package's on the same tokens."""
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    synthetic.make_npy_records(ours, num_images=6, num_questions=20,
                               n_answers=8, seed=5)
    j_synthetic.make_dataset(theirs, num_images=6, num_questions=20,
                             img_size=8, n_answers=8, seed=5)
    for name in ("train.npy", "valid.npy"):
        a = np.load(os.path.join(ours, name), allow_pickle=True)
        b = np.load(os.path.join(theirs, name), allow_pickle=True)
        assert len(a) == len(b) == 20
        for ra, rb in zip(a, b):
            assert ra.keys() == rb.keys()
            for k in ra:
                if k != "image_path":
                    assert ra[k] == rb[k], k
            assert os.path.basename(ra["image_path"]) == os.path.basename(
                rb["image_path"])
    for sub in ("Questions", "Annotations"):
        for f in os.listdir(os.path.join(theirs, sub)):
            with open(os.path.join(ours, sub, f)) as x, \
                    open(os.path.join(theirs, sub, f)) as y:
                assert x.read() == y.read()

    vs, j_vs = metrics.VqaStruct(synth), j_metrics.VqaStruct(synth)
    assert dict(vs.img_to_qst) == dict(j_vs.img_to_qst)
    assert dict(vs.img_to_qa) == dict(j_vs.img_to_qa)

    rng = np.random.default_rng(6)
    words = ["what", "is", "the", "color", "cat", "dog", "red", "sky"]
    for _ in range(300):
        refs = [list(rng.choice(words, rng.integers(1, 9)))
                for _ in range(rng.integers(1, 4))]
        hyp = list(rng.choice(words, rng.integers(0, 9)))
        assert metrics.BLEU4(refs, hyp) == j_metrics.BLEU4(refs, hyp)
    names = pipeline.get_loader(synth, 8)["valid"].image_names(np.arange(8))
    qv, j_qv = (VocabDict(os.path.join(synth, "vocab_questions.txt")),
                JVocab(os.path.join(synth, "vocab_questions.txt")))
    toks = rng.integers(0, qv.vocab_size, (8, 8))
    assert metrics.calc_bleu_scores(names, toks, qv, vs) == \
        j_metrics.calc_bleu_scores(names, toks, j_qv, j_vs)


def test_val_reports_bleu4_of_the_greedy_questions(tmp_path, synth):
    """Experiment.val on make_dataset's directory logs BLEU4: the mean over
    its batches of the JAX package's calc_bleu_scores of each batch's
    greedy questions."""
    cfg = small_test_config()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, **TINY, **STEPS),
        train=dataclasses.replace(cfg.train, skip_stage3=True, batch_size=8,
                                  report_freq=1),
        data=dataclasses.replace(cfg.data, input_dir=synth),
        root_stats_dir=str(tmp_path), exp_name="val")
    exp = Experiment(cfg, device="cpu")
    exp.val()
    log = (tmp_path / "val" / "log.txt").read_text()
    shown = float(log.split("BLEU4: ")[1].split()[0])
    j_vs = j_metrics.VqaStruct(synth)
    j_qv = JVocab(os.path.join(synth, "vocab_questions.txt"))
    scores = []
    for batch in exp._batches("valid", shuffle=False):
        gen = exp._eval_step(batch)[3].numpy()
        names = exp.data["valid"].image_names(batch["index"])
        scores.append(j_metrics.calc_bleu_scores(names, gen, j_qv, j_vs))
    assert len(scores) == 2
    assert shown == pytest.approx(np.mean(scores), abs=5e-5)


def test_eval_reads_a_jax_derived_checkpoint_as_the_jax_eval_does(
        tmp_path, synth, monkeypatch, capsys):
    """python -m lctvqa_torch.eval on a derived EF checkpoint the JAX
    package wrote (its config, its optax state, HWIO convs): the
    accuracy and BLEU4 the JAX package's eval prints for it. --int8 runs
    it quantized (tests/test_torch_quant.py holds the int8 forwards to
    the JAX package's); --tp 2 on one rank raises (tests/test_torch_
    parallel.py runs it on two); without a card the default device
    raises."""
    from lctvqa import eval as j_eval, native as j_native
    from lctvqa_torch import native

    # the JAX gather's native library: tests/test_native.py may be
    # rewriting it in another worker; the port's C++ core is held off the
    # same way, so both loaders take the numpy route
    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    j_cfg, _ = _derived_cfgs(**{k: v for k, v in TINY.items()
                                if k not in ("vgg_width_mult",
                                             "vgg_fc_dim")})
    params, _ = j_ef.init_ef_model(jax.random.PRNGKey(4), j_cfg.model)
    exp_dir = tmp_path / "exp" / "jx"
    exp_dir.mkdir(parents=True)
    j_ckpt.save_state(str(exp_dir / "ef_model.ckpt"), {
        "ef_params": params,
        "ef_opt": j_optim.model_optimizer(j_cfg.train).init(params),
        "arch": None, "arch_opt": None, "epoch": 1}, config=j_cfg)
    argv = ["--exp", "jx", "--root_stats_dir", str(tmp_path / "exp"),
            "--input_dir", synth, "--batch_size", "8", "--num_batches", "2"]
    j_eval.main(argv)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    got = t_eval.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == want, (out, want)
    assert "model config from checkpoint" in out and "argmax:" in out
    assert got["n"] == 16 and 0.0 <= got["acc"] <= 1.0
    got = t_eval.main(argv + ["--device", "cpu", "--int8"])
    assert "serving int8" in capsys.readouterr().out
    assert got["n"] == 16 and 0.0 <= got["acc"] <= 1.0
    assert 0.0 <= got["bleu4"] <= 100.0
    with pytest.raises(SystemExit, match="--tp 2 needs 2 ranks"):
        t_eval.main(argv + ["--device", "cpu", "--tp", "2",
                            "--num_devices", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            t_eval.main(argv)


def test_cli_retrains_a_derived_net_then_evaluates_it(tmp_path, synth):
    """python -m lctvqa_torch.main --arch_type derived --genotype
    PC_DARTS_cifar --tiny --device cpu for one epoch (stages 1 and 2 and
    validation with BLEU4; no stage 3, no arch), then python -m
    lctvqa_torch.eval --device cpu on its checkpoint."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "lctvqa_torch.main", "--tiny", "--device",
         "cpu", "--input_dir", synth, "--img_size", "32", "--batch_size",
         "8", "--num_epochs", "1", "--compute_dtype", "float32", "--exp",
         "drv", "--arch_type", "derived", "--genotype", "PC_DARTS_cifar"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = tmp_path / "experiment_data" / "drv"
    log = (out / "log.txt").read_text()
    assert "STAGE3" not in log and "genotype: " not in log
    assert "| VALID SET | Epoch [01/01], Loss:" in log and "BLEU4: " in log
    state = checkpoint.load_state(str(out / "ef_model.ckpt"))
    assert state["arch"] is None and state["ef_opt"]["step"] == 2
    cfg = checkpoint.config_from_state(state)
    assert cfg.model.genotype == genotypes.PC_DARTS_cifar
    assert (cfg.model.darts_steps, cfg.model.darts_multiplier) == (4, 4)
    proc = subprocess.run(
        [sys.executable, "-m", "lctvqa_torch.eval", "--device", "cpu",
         "--exp", "drv", "--input_dir", synth, "--batch_size", "8",
         "--num_batches", "2"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "val multi-choice acc (unk-masked): " in proc.stdout
    assert "BLEU4 " in proc.stdout and "T=0.1: " in proc.stdout
