"""The export CLI (`python -m lctvqa_torch.export`), int8 artifacts and
int8 eval, on the CPU, against the JAX package where it has the
counterpart.

- The CLI on the port's own checkpoints (the W model, a derived EF, a
  DARTS-family EF with its arch_par.ckpt), fp and --int8, each with
  `--check --device cpu` (the reloaded artifact against the model
  functions on the checkpoint's trees: floats within 2e-4, tokens and
  ids exact, as lctvqa/export.py's check); on a directory the JAX
  package's Experiment wrote; --int8 on the supernet and a wrong
  --input_dir vocabulary refused.
- The JAX package reads the port's int8 artifact, its leaves equal to
  those of its own `export_state(int8=True)` of the same params; the
  port's ServingModel serves the JAX package's int8 artifact with the
  answers of the JAX package's ServingModel (logits within 1e-4).
- `python -m lctvqa_torch.eval --int8 --device cpu` on a derived EF.

fp32, the `--tiny` model of lctvqa_torch/main.py on make_dataset's
32-pixel synthetic data (W's VGG19 needs 32 pixels); the JAX artifacts
at tests/test_export.py's sizes, exported for the CPU only.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from lctvqa import export as j_export
from lctvqa.config import (Config as JConfig, DataConfig as JDataConfig,
                           ModelConfig as JModelConfig,
                           TrainConfig as JTrainConfig)
from lctvqa.models import vqa_w as j_w
from lctvqa.train.experiment import Experiment as JExperiment
from lctvqa_torch import convert, eval as t_eval, export
from lctvqa_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from lctvqa_torch.data import synthetic
from lctvqa_torch.models import genotypes
from lctvqa_torch.train.experiment import Experiment
from lctvqa_torch.train.experiment_darts import DartsExperiment
from test_torch_train import one_cpu_thread  # noqa: F401 (autouse)

# the --tiny model's dims (lctvqa_torch/main.py) on make_dataset's vocabs
TINY = dict(img_embed_size=16, word_embed_size=8, lstm_hidden_size=16,
            max_qst_len=8, darts_init_ch=4, darts_layers=1, darts_steps=2,
            darts_multiplier=2, vgg_width_mult=1 / 16, vgg_fc_dim=32,
            img_size=32, qst_vocab_size=24, ans_vocab_size=16,
            compute_dtype="float32")
DATA = dict(num_images=8, num_questions=16, img_size=32, n_answers=16)
DERIVED = dict(arch_type="derived", genotype=genotypes.PC_DARTS_cifar,
               darts_layers=3, darts_steps=4, darts_multiplier=4)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_export_synth"))
    synthetic.make_dataset(d, **DATA)
    return d


def _cfg(synth, root, name, **model_kw):
    return Config(model=ModelConfig(**{**TINY, **model_kw}),
                  train=TrainConfig(batch_size=8, num_epochs=1,
                                    skip_stage3=True),
                  data=DataConfig(input_dir=synth), root_stats_dir=str(root),
                  exp_name=name)


def _cli(root, exp, model, *flags):
    return export.main(["--exp", exp, "--root_stats_dir", str(root),
                        "--model", model, "--device", "cpu", *flags])


@pytest.fixture(scope="module")
def port_exps(synth, tmp_path_factory):
    """Experiment directories the port wrote: LCT runs on the fixed VGG19
    EF (ef and w checkpoints), on a derived EF and on the supernet, and a
    DARTS-family run (vqa_model.ckpt and arch_par.ckpt); saved after
    init, no step."""
    root = tmp_path_factory.mktemp("port_exps")
    Experiment(_cfg(synth, root, "fixed", arch_type="fixed"),
               device="cpu").save_model()
    Experiment(_cfg(synth, root, "derived", **DERIVED),
               device="cpu").save_model()
    Experiment(_cfg(synth, root, "supernet"), device="cpu").save_model()
    DartsExperiment(_cfg(synth, root, "darts"), device="cpu").save_model()
    return root


@pytest.mark.parametrize("exp,model,int8", [
    ("fixed", "w", False), ("fixed", "w", True), ("fixed", "ef", True),
    ("derived", "ef", False), ("derived", "ef", True),
    ("darts", "vqa", False)])
def test_cli_exports_and_checks_port_checkpoints(port_exps, synth, exp,
                                                 model, int8, capsys):
    """--check passes; the artifact's meta and leaves say what was asked:
    int8 codes where quantized, the supernet's arch from arch_par.ckpt."""
    out = _cli(port_exps, exp, model, "--input_dir", synth, "--check",
               *(["--int8"] if int8 else []))
    assert out == os.path.join(port_exps, exp, f"{model}_serving.lctx")
    printed = capsys.readouterr().out
    assert "check ok" in printed and f"int8={int8}" in printed
    art = export.read_artifact(out)
    assert art["meta"]["int8"] is int8 and art["meta"]["qst_words"]
    dtypes = {a.dtype for a in jax.tree_util.tree_leaves(
        art["params"]["params"])}
    assert (np.dtype(np.int8) in dtypes) == int8
    assert ("arch" in art["params"]) == (exp == "darts")


def test_cli_refuses_the_supernet_int8_and_a_wrong_vocabulary(port_exps,
                                                              tmp_path):
    with pytest.raises(ValueError, match="cannot serve the darts supernet"):
        _cli(port_exps, "darts", "vqa", "--int8")
    other = str(tmp_path / "other")
    synthetic.make_dataset(other, **dict(DATA, n_answers=12))
    with pytest.raises(ValueError, match="vocab mismatch"):
        _cli(port_exps, "fixed", "w", "--input_dir", other)


def test_cli_exports_a_jax_experiment(synth, tmp_path, capsys):
    """The JAX package's Experiment (supernet EF, VGG19 W) writes its
    checkpoints; the port's CLI exports both, W int8, each with --check
    on the CPU, and the EF artifact holds the converted params."""
    model = JModelConfig(**TINY)
    cfg = JConfig(model=model,
                  train=JTrainConfig(batch_size=8, skip_stage3=True),
                  data=JDataConfig(input_dir=synth),
                  root_stats_dir=str(tmp_path), exp_name="jx")
    jexp = JExperiment(cfg, use_mesh=False)
    jexp.save_model()
    _cli(tmp_path, "jx", "w", "--int8", "--check", "--input_dir", synth)
    out = _cli(tmp_path, "jx", "ef", "--check")
    assert capsys.readouterr().out.count("check ok") == 2
    got = export.read_artifact(out)["params"]["params"]
    want = jax.tree_util.tree_map(np.asarray, jexp.ef_params)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def w_int8(tiny_cfg):
    """tests/test_export.py's W model (VGG19 at 32 pixels) and the JAX
    package's int8 artifact of it, exported for the CPU."""
    mcfg = dataclasses.replace(tiny_cfg.model, img_size=32,
                               arch_type="fixed")
    params = j_w.init_w_model(jax.random.PRNGKey(2), mcfg)
    art = j_export.export_state({"w_params": params, "epoch": 1}, mcfg,
                                int8=True, platforms=("cpu",))
    return mcfg, params, art


def test_jax_package_reads_the_port_int8_artifact(w_int8, tmp_path):
    """The port's export_state(int8=True) of the same params, written by
    the port and read by lctvqa.export.read_artifact: every leaf equal to
    the JAX package's own int8 export's (codes, scales, the fp leaves)."""
    mcfg, params, want = w_int8
    t_mcfg = ModelConfig(**{f.name: getattr(mcfg, f.name)
                            for f in dataclasses.fields(ModelConfig)})
    state = {"w_params": convert.from_jax(
        jax.tree_util.tree_map(np.asarray, params)), "epoch": 1}
    path = str(tmp_path / "port_int8.lctx")
    export.save_artifact(export.export_state(state, t_mcfg, int8=True), path)
    got = j_export.read_artifact(path)
    assert got["meta"]["int8"] is True and got["meta"]["family"] == "w"
    assert (jax.tree_util.tree_structure(got["params"])
            == jax.tree_util.tree_structure(want["params"]))
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(want["params"])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_serves_the_jax_int8_artifact(w_int8, tmp_path):
    """The JAX package's int8 artifact file through the port's
    ServingModel on the CPU: the answers of the JAX package's
    ServingModel (its exported program), logits within 1e-4."""
    mcfg, _, art = w_int8
    path = str(tmp_path / "jax_int8.lctx")
    j_export.save_artifact(art, path)
    jmodel = j_export.load_artifact(path)
    model = export.load_artifact(path, device="cpu",
                                 compute_dtype="float32")
    rng = np.random.default_rng(5)
    for batch in (3, 17):  # 17 rows: past the card's GEMM minimum of 16
        u8 = rng.integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8)
        qst = rng.integers(0, mcfg.qst_vocab_size, (batch, mcfg.max_qst_len),
                           dtype=np.int32)
        want = np.asarray(jmodel.answer_logits(u8, qst))
        got = model.answer_logits(u8, qst).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_eval_int8_on_a_derived_checkpoint(port_exps, synth, capsys):
    """python -m lctvqa_torch.eval --int8 --device cpu: the derived EF
    served int8 (accuracy and BLEU4 in range); the supernet refused."""
    argv = ["--root_stats_dir", str(port_exps), "--input_dir", synth,
            "--batch_size", "8", "--num_batches", "2", "--device", "cpu",
            "--int8"]
    got = t_eval.main(["--exp", "derived"] + argv)
    assert "serving int8" in capsys.readouterr().out
    assert got["n"] == 16 and 0.0 <= got["acc"] <= 1.0
    assert 0.0 <= got["bleu4"] <= 100.0
    with pytest.raises(SystemExit, match="darts supernet"):
        t_eval.main(["--exp", "supernet"] + argv)
