"""The supernet's three other ways of running the same math in the port
(`remat_cells`, `pack_conv_branches`, `fuse_mixed_ops`) through the
training steps, the experiment, the CLI and the serving programs, on the
CPU in fp32 (their networks against the JAX package's are
tests/test_torch_search_modes.py).

Against the port's own default path (held to the JAX package elsewhere),
one case a flag and step: an LCT stage-1, stage-2 and stage-3 step (fd
and exact-indirect), a darts train step and a darts arch step (exact:
the cells' checkpoints under create_graph), on the same weights, batches
and generator seeds, with the small supernet of tests/test_torch_train.py
at 32 px (W's VGG19 needs 32): the loss and the counters, and the
gradient each step hands its optimizer, read back as Adam's first moment
(1 - b1) * g, within STEP_TOL = 2e-3 of each leaf's scale (the loosest
of the JAX tests' gradient tolerances for these modes). Then the
counterpart of tests/test_experiment.py's 224 px lazy-reader run with
`remat_cells`, a CLI epoch of each flag, every option of the JAX CLI on
the port's, and a supernet artifact served with `fuse_mixed_ops` or
`remat_cells` as `torch.export` programs equal to its eager calls.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lctvqa import main as j_main
from lctvqa_torch import main as t_main
from lctvqa_torch.optim.optimizers import tree_leaves
from lctvqa_torch.train import steps as t_steps
from lctvqa_torch.train.experiment_darts import make_darts_steps
from test_torch_train import (_batch, _cfgs, _t, jax_ref,  # noqa: F401
                              one_cpu_thread)
# (jax_ref and one_cpu_thread are fixtures, the second autouse)


# ---------------------------------------------------------------------------
# the steps against the port's default path
# ---------------------------------------------------------------------------

FLAGS = {"remat": {"remat_cells": True}, "pack": {"pack_conv_branches": True},
         "fused": {"fuse_mixed_ops": True}}
STEPS = ("stage1", "stage2", "stage3-fd", "stage3-exact-indirect",
         "darts_train", "darts_arch-exact")
STEP_TOL = 2e-3
LR = 1e-3


def _step_inputs():
    """Weights and batches of the step comparisons: the small supernet at
    32 px (W's VGG19 needs 32), its arch drawn off the uniform mixture."""
    _, t_cfg = _cfgs(img_size=32)
    gen = torch.Generator().manual_seed(4)
    from lctvqa_torch.models import vqa_ef, vqa_w
    ef, arch = vqa_ef.init_ef_model(gen, t_cfg.model)
    arch = {k: torch.randn(v.shape, generator=gen)
            for k, v in arch.items()}
    w = vqa_w.init_w_model(gen, t_cfg.model)
    return {"ef": ef, "arch": arch, "w": w,
            "train": _t(_batch(t_cfg.model, seed=21)),
            "valid": _t(_batch(t_cfg.model, seed=22))}


def _run_step(step: str, flags: dict, inp: dict) -> dict:
    """One step at `flags` -> {"loss", "counts", "grad": the first
    moment the step's optimizer kept, (1 - b1) * g}."""
    mode = step.split("-", 1)[1] if "-" in step else None
    _, t_cfg = _cfgs(img_size=32, **flags)
    if mode is not None:
        t_cfg = t_cfg.replace(train=dataclasses.replace(
            t_cfg.train, architect_mode=mode))
    gen = torch.Generator().manual_seed(30)
    ef, arch, w = inp["ef"], inp["arch"], inp["w"]
    if step == "darts_train":
        darts = make_darts_steps(t_cfg, 1)
        _, opt, loss = darts["train"](ef, darts["tx"].init(ef), arch,
                                      inp["train"], gen)
        return {"loss": float(loss), "counts": (), "grad": opt["m"]}
    if step.startswith("darts_arch"):
        darts = make_darts_steps(t_cfg, 1)
        _, opt, loss = darts["arch"](arch, darts["arch_tx"].init(arch), ef,
                                     inp["train"], inp["valid"], LR, gen)
        return {"loss": float(loss), "counts": (), "grad": opt["m"]}
    steps = t_steps.make_lct_steps(t_cfg, 1, "cpu")
    if step == "stage1":
        _, opt, loss, c1, c2 = steps["stage1"](
            ef, arch, steps["ef_tx"].init(ef), inp["train"], gen)
        counts = (int(c1), int(c2))
    elif step == "stage2":
        _, opt, loss, corr = steps["stage2"](
            w, steps["w_tx"].init(w), ef, arch, inp["train"], gen,
            torch.Generator().manual_seed(31))
        counts = (int(corr),)
    else:
        _, opt, loss = steps["stage3"](
            arch, steps["arch_tx"].init(arch), ef, w, inp["train"],
            inp["valid"], LR, LR, gen)
        counts = ()
    return {"loss": float(loss), "counts": counts, "grad": opt["m"]}


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_step_matches_the_default_path(flag, step, jax_ref):
    """The step with the flag against the same step at the default flags:
    loss within 1e-5 relative (1e-4 for the architects' unrolled
    validation), counters equal, every gradient leaf within
    STEP_TOL of its scale (floor 1e-9 for leaves the loss barely
    reaches)."""
    inp = jax_ref("step_inputs", _step_inputs)
    want = jax_ref(("default_step", step),
                   lambda: _run_step(step, {}, inp))
    got = _run_step(step, FLAGS[flag], inp)
    rtol = 1e-4 if "-" in step else 1e-5
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=rtol)
    assert got["counts"] == want["counts"]
    scales = []
    for a, b in zip(tree_leaves(got["grad"]), tree_leaves(want["grad"])):
        scale = float(b.abs().max())
        scales.append(scale)
        assert float((a - b).abs().max()) <= STEP_TOL * scale + 1e-9, (
            flag, step, scale)
    assert max(scales) > 0


# ---------------------------------------------------------------------------
# the experiment and the CLI
# ---------------------------------------------------------------------------

def test_lct_224px_lazy_remat(tmp_path):
    """tests/test_experiment.py::test_lct_224px_lazy_remat on the port:
    224 px images read through the chunked h5 path (lazy) with
    `remat_cells`, one epoch of stages 1 and 2 at its dims, finite
    losses."""
    from lctvqa_torch.config import (Config, DataConfig, ModelConfig,
                                     TrainConfig)
    from lctvqa_torch.data.synthetic import make_dataset
    from lctvqa_torch.text import VocabDict
    from lctvqa_torch.train.experiment import Experiment

    d = str(tmp_path / "synth224")
    make_dataset(d, num_images=4, num_questions=8, img_size=224,
                 n_answers=8)
    qv = VocabDict(f"{d}/vocab_questions.txt")
    av = VocabDict(f"{d}/vocab_answers.txt")
    model = ModelConfig(
        img_embed_size=16, word_embed_size=8, lstm_hidden_size=16,
        max_qst_len=6, qst_vocab_size=qv.vocab_size,
        ans_vocab_size=av.vocab_size, img_size=224, darts_init_ch=4,
        darts_layers=1, darts_steps=2, darts_multiplier=2,
        compute_dtype="float32", vgg_width_mult=1 / 16, vgg_fc_dim=32,
        remat_cells=True)
    cfg = Config(model=model,
                 train=TrainConfig(batch_size=4, num_epochs=1,
                                   skip_stage2=False, skip_stage3=True,
                                   report_freq=1),
                 data=DataConfig(input_dir=d, preload_images="lazy"),
                 exp_name="e224", root_stats_dir=str(tmp_path / "s"))
    exp = Experiment(cfg, device="cpu")
    assert not isinstance(exp.data["train"].images, np.ndarray)  # lazy
    exp.train_epoch()
    assert np.isfinite(exp.train_ef_loss[0])
    assert np.isfinite(exp.train_w_loss[0])


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    from lctvqa_torch.data.synthetic import make_dataset
    d = str(tmp_path_factory.mktemp("cli_modes"))
    make_dataset(d, num_images=8, num_questions=16, img_size=32)
    return d


@pytest.mark.parametrize("flag", ["--fuse_mixed_ops", "--remat_cells",
                                  "--pack_conv_branches"])
def test_each_mode_flag_runs_a_cli_epoch(flag, cli_dir, tmp_path,
                                         monkeypatch):
    """`python -m lctvqa_torch.main --tiny --device cpu <flag>`: the flag
    reaches the model config and one epoch of stages 1 and 2 runs, with
    finite losses."""
    monkeypatch.chdir(tmp_path)
    exp = t_main.main(["--tiny", "--device", "cpu", "--skip_stage3",
                       "--input_dir", cli_dir, "--img_size", "32",
                       "--batch_size", "8", "--num_epochs", "1",
                       "--compute_dtype", "float32", "--exp", "m", flag])
    assert getattr(exp.cfg.model, flag[2:])
    assert np.isfinite(exp.train_ef_loss[0] + exp.train_w_loss[0])
    assert (tmp_path / "experiment_data" / "m" / "ef_model.ckpt").exists()


def _every_option(parser):
    """argv that sets every option of the JAX CLI's parser to a value
    other than its default where it can: store_true flags on,
    BooleanOptionalAction flags negated, choices their last, numbers
    moved, strings a token."""
    argv = []
    for action in parser._actions:
        if not action.option_strings or action.dest == "help":
            continue
        opt = action.option_strings[0]
        if action.nargs == 0 and len(action.option_strings) == 1:
            argv.append(opt)                      # store_true
        elif action.nargs == 0:                   # BooleanOptionalAction
            argv.append(next(o for o in action.option_strings
                             if o.startswith("--no")) if action.default
                        else opt)
        elif action.choices:
            argv += [opt, str(list(action.choices)[-1])]
        elif action.type in (int, float):
            argv += [opt, str(action.type(3))]
        elif action.dest == "genotype":
            argv += [opt, "PC_DARTS_cifar"]
        else:
            argv += [opt, f"v_{action.dest}"]
    return argv


def test_every_jax_cli_option_is_the_ports():
    """Every option of lctvqa.main's parser exists in the port's parser,
    parses there and raises nothing, and the config it gives is the JAX
    CLI's for the same command line, field by field (the port's MeshConfig
    keeps the fields it has)."""
    j_parser, t_parser = j_main.build_parser(), t_main.build_parser()
    t_options = {o for a in t_parser._actions for o in a.option_strings}
    for action in j_parser._actions:
        assert set(action.option_strings) <= t_options, action.option_strings
    argv = _every_option(j_parser)
    assert {"--fuse_mixed_ops", "--remat_cells",
            "--pack_conv_branches"} <= set(argv)
    j_cfg = j_main.config_from_args(j_parser.parse_args(argv))
    t_cfg = t_main.config_from_args(t_parser.parse_args(argv))
    for part in ("model", "train", "data"):
        want = dataclasses.asdict(getattr(j_cfg, part))
        got = dataclasses.asdict(getattr(t_cfg, part))
        for field, value in want.items():
            if field == "genotype":
                assert repr(got[field]) == repr(value)
            elif field in got:
                assert got[field] == value, (part, field)
    for field in ("num_devices", "multihost"):
        assert getattr(t_cfg.mesh, field) == getattr(j_cfg.mesh, field)
    assert (t_cfg.exp_name, t_cfg.resume) == (j_cfg.exp_name, j_cfg.resume)


@pytest.mark.parametrize("flag", ["fuse_mixed_ops", "remat_cells"])
def test_serving_programs_with_the_flag_equal_the_eager_calls(flag):
    """A darts-EF artifact served with the flag set (and the kernel flags,
    as tests/test_torch_export_programs.py serves it) traces through
    `export.export_programs` on the CPU, and each program equals the eager
    call bit for bit at batches 1 and 3. No gradient is taken in either,
    so `remat_cells` runs the plain cell; `fuse_mixed_ops` takes the
    edge-batched cell ahead of the node operator, whose graph then holds
    no `mixed_node`."""
    from lctvqa_torch.export import ServingModel, export_programs
    from test_torch_export_programs import (CASES, _args, _artifact,
                                            _graph_ops, _inputs, _tuple,
                                            bn_switch)

    _, dims, flags, bn = CASES["darts"]
    artifact, _ = _artifact("darts")
    model = ServingModel(artifact, "cpu", compute_dtype="float32",
                         **flags, **{flag: True})
    assert getattr(model.config, flag)
    with bn_switch(bn):
        programs = export_programs(model, max_batch=4)
        for fn, program in programs.items():
            ops = _graph_ops(program)
            assert ("mixed_node" in ops) == (flag != "fuse_mixed_ops"), ops
            run = program.module()
            for b, seed in ((1, 3), (3, 4)):
                args = _args(fn, *_inputs(model, b, seed))
                want = _tuple(getattr(model, fn)(*args))
                got = _tuple(run(*args))
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and torch.equal(g, w), (fn, b)
