"""The LCT loop's statistics files (lctvqa_torch/train/stats.py and
Experiment._record_stats / _read_stats) against the JAX package's
lctvqa/train/stats.py: the six per-epoch JSON lists byte-equal on the
same values, continued by a resumed run, and the three loss/accuracy
PNGs drawn where matplotlib is importable and skipped with a log line
where it is not.

A two-node supernet EF and a 1/16-width VGG19 W on 32-pixel synthetic
data in RAM, fp32 on the CPU, batch 8 (test_torch_train_steps.py's
experiment): an epoch takes about a second.
"""

import dataclasses
import filecmp
import sys

import numpy as np
import pytest

from lctvqa.train import stats as j_stats
from lctvqa_torch.config import small_test_config
from lctvqa_torch.data import pipeline, synthetic
from lctvqa_torch.train import stats
from lctvqa_torch.train.experiment import PLOTS, STATS, Experiment
from test_torch_train import one_cpu_thread  # noqa: F401 (autouse)

DATA = dict(num_images=8, num_questions=24, img_size=32, n_answers=16)
# values whose JSON text is not trivial: repeating fractions, an integer
# float, a value near 0 written with an exponent
VALUES = {name: [1 / 3 + i, 2.0 * i, 1e-9 * (i + 1), 0.1 * (i + 7)]
          for i, name in enumerate(STATS)}


@pytest.fixture(scope="module")
def arrays():
    return synthetic.make_arrays(**DATA)


def _cfg(root, num_epochs=1):
    cfg = small_test_config()
    model = dataclasses.replace(
        cfg.model, img_embed_size=16, word_embed_size=8, lstm_hidden_size=16,
        max_qst_len=8, img_size=32, darts_layers=1, darts_steps=2,
        darts_multiplier=2, vgg_width_mult=1 / 16, vgg_fc_dim=32,
        qst_vocab_size=24, ans_vocab_size=16)
    return cfg.replace(
        model=model, root_stats_dir=str(root), exp_name="exp",
        train=dataclasses.replace(cfg.train, skip_stage3=True, batch_size=8,
                                  num_epochs=num_epochs))


def _experiment(root, arrays, **kw):
    cfg = _cfg(root, **{k: v for k, v in kw.items() if k == "num_epochs"})
    if kw.get("resume"):
        cfg = cfg.replace(resume=True)
    return Experiment(cfg, device="cpu",
                      data=pipeline.loader_from_arrays(arrays))


def test_stats_files_equal_the_jax_packages(tmp_path, arrays):
    """The port's _record_stats and the JAX stats.write_to_file_in_dir on
    the same six lists write the same bytes; each package reads the
    other's file back as the same list."""
    exp = _experiment(tmp_path / "port", arrays)
    for name, vals in VALUES.items():
        setattr(exp, name, list(vals))
    exp._record_stats()
    for name, vals in VALUES.items():
        j_stats.write_to_file_in_dir(str(tmp_path / "jax"), f"{name}.txt",
                                     vals)
        port_file = tmp_path / "port" / "exp" / f"{name}.txt"
        assert filecmp.cmp(port_file, tmp_path / "jax" / f"{name}.txt",
                           shallow=False), name
        assert j_stats.read_file_in_dir(str(port_file.parent),
                                        port_file.name) == vals
        assert stats.read_file_in_dir(str(tmp_path / "jax"),
                                      f"{name}.txt") == vals
    assert stats.read_file_in_dir(str(tmp_path), "missing.txt") == []


def test_a_resumed_run_continues_the_lists(tmp_path, arrays):
    """An epoch writes the six lists (one value each) and the three
    plots; a run resumed with a second epoch reads them back and writes
    two values each, the first unchanged."""
    exp = _experiment(tmp_path, arrays)
    exp.run()
    exp_dir = tmp_path / "exp"
    first = {name: j_stats.read_file_in_dir(str(exp_dir), f"{name}.txt")
             for name in STATS}
    assert all(len(v) == 1 and np.isfinite(v).all() for v in first.values())
    assert first["train_ef_loss"] == exp.train_ef_loss
    for _, _, _, fname in PLOTS:
        assert (exp_dir / fname).stat().st_size > 0
    again = _experiment(tmp_path, arrays, num_epochs=2, resume=True)
    assert {name: getattr(again, name) for name in STATS} == first
    again.run()
    for name in STATS:
        got = j_stats.read_file_in_dir(str(exp_dir), f"{name}.txt")
        assert len(got) == 2 and got[0] == first[name][0], name
        assert got == getattr(again, name)[:2], name


def test_plots_skipped_without_matplotlib(tmp_path, arrays, monkeypatch):
    """With matplotlib unimportable the JSON files are written, no PNG
    is, and each skipped plot logs one line (to the experiment's
    log.txt)."""
    exp = _experiment(tmp_path, arrays)
    for name, vals in VALUES.items():
        setattr(exp, name, list(vals))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    exp._record_stats()
    exp_dir = tmp_path / "exp"
    for name, vals in VALUES.items():
        assert j_stats.read_file_in_dir(str(exp_dir), f"{name}.txt") == vals
    for _, _, _, fname in PLOTS:
        assert not (exp_dir / fname).exists()
        assert (exp_dir / "log.txt").read_text().count(
            f"matplotlib is not installed: {exp_dir / fname} not drawn") == 1
    assert not stats.plot_loss_acc([1.0], [0.5], "x",
                                   str(tmp_path / "x.png"))
