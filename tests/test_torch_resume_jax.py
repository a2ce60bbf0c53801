"""The port's LCT Experiment (lctvqa_torch/train/experiment.py) resumes an
experiment directory that the JAX package's Experiment wrote: both
checkpoints, `ef_model.ckpt` (EF params, arch, their Adam states and,
where the file has them, BatchNorm running statistics) and
`w_model.ckpt` (W params, Adam state), read back equal by key to the JAX
trees after `convert.from_jax` (conv weights HWIO -> OIHW, optax's
namedtuples -> the port's {"step", "lr", "m", "v"}).

`small_test_config()` on the synthetic dataset (conftest's synth_dir).
No JAX step runs: the JAX Experiment is built and saved only, with
random Adam moments and step counts written into its optax states, as
after some steps.
"""

import dataclasses
import os

import numpy as np
import pytest

from lctvqa.config import small_test_config as j_small_config
from lctvqa.text import VocabDict as JVocab
from lctvqa.train import checkpoint as j_ckpt
from lctvqa.train.experiment import Experiment as JExperiment
from lctvqa_torch import convert
from lctvqa_torch.config import small_test_config
from lctvqa_torch.data import pipeline
from lctvqa_torch.train.experiment import Experiment
from test_torch_darts import _random_opt, _trees_equal
from test_torch_train import one_cpu_thread  # noqa: F401 (autouse)


def _cfgs(synth_dir, root):
    """(JAX config, port config) at small_test_config() on synth_dir."""
    qv, av = (JVocab(os.path.join(synth_dir, f)).vocab_size
              for f in ("vocab_questions.txt", "vocab_answers.txt"))
    out = []
    for cfg in (j_small_config(), small_test_config()):
        out.append(cfg.replace(
            model=dataclasses.replace(cfg.model, qst_vocab_size=qv,
                                      ans_vocab_size=av),
            data=dataclasses.replace(cfg.data, input_dir=synth_dir),
            root_stats_dir=str(root), exp_name="exp"))
    return tuple(out)


@pytest.mark.parametrize("running", [False, True],
                         ids=["save_model", "with-running-stats"])
def test_port_resumes_the_jax_lct_checkpoints(synth_dir, tmp_path, running):
    """The JAX Experiment writes ef_model.ckpt and w_model.ckpt with
    save_model() (and, in the second case, the same entries with
    BatchNorm running statistics beside them); the port's Experiment
    with resume=True reads both: params, arch, running statistics and
    every Adam state's step, learning rate and moments equal by key."""
    j_cfg, t_cfg = _cfgs(synth_dir, tmp_path)
    jexp = JExperiment(j_cfg, use_mesh=False)
    arch_lr = j_cfg.train.arch_learning_rate
    want_opt = {
        "ef_opt": _random_opt(convert.from_jax(jexp.ef_params), 1, 7, 5e-4),
        "w_opt": _random_opt(convert.from_jax(jexp.w_params), 2, 9, 4e-4),
        "arch_opt": _random_opt(convert.from_jax(jexp.arch), 3, 3, arch_lr)}
    for k, opt in want_opt.items():
        setattr(jexp, k, convert.opt_state_to_jax(opt, getattr(jexp, k)))
    jexp.current_epoch = 2
    jexp.save_model()
    bn_running = None
    if running:
        rng = np.random.default_rng(5)
        bn_running = [{"mean": rng.standard_normal(c).astype(np.float32),
                       "var": rng.random(c).astype(np.float32)}
                      for c in (4, 8, 16)]
        path = os.path.join(jexp.exp_dir, "ef_model.ckpt")
        j_ckpt.save_state(path, dict(j_ckpt.load_state(path),
                                     bn_running=bn_running))

    texp = Experiment(t_cfg.replace(resume=True), device="cpu",
                      data=pipeline.get_loader(synth_dir, 8, 1.0))
    assert texp.current_epoch == 3
    for got, want in ((texp.ef_params, jexp.ef_params),
                      (texp.w_params, jexp.w_params),
                      (texp.arch, jexp.arch)):
        assert _trees_equal(got, convert.from_jax(want))
    if running:
        assert _trees_equal(texp.bn_running, convert.from_jax(bn_running))
    else:
        assert texp.bn_running is None
    for k, want in want_opt.items():
        got = getattr(texp, k)
        assert (got["step"], got["lr"]) == (want["step"],
                                            pytest.approx(want["lr"])), k
        assert _trees_equal(got["m"], want["m"]), k
        assert _trees_equal(got["v"], want["v"]), k
