"""Each cell driven end to end on the CPU at a tiny size, through the
program's own routes (the kernels' plain versions) and the harness's
window and check: a sound run comes out correct under the cell's limits;
with the timed path broken underneath, once for each fault the cell can
have, it comes out not correct; and so does each cell's control."""

from __future__ import annotations

import pytest

from conftest import CELLS, tiny_spec
from portbench import calibrate, run
from portbench.drivers import train
from portbench.reference import model as R

SEED = 2 ** 31 + 977   # more than 32 signed bits hold


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, cpu):
    r = run.execute(tiny_spec(cell), SEED, 1.0, False, cpu)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    spec_e2e = {m["name"] for m in tiny_spec(cell)["end_to_end"]}
    assert set(r["metrics"]) == spec_e2e
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell, fault", [
    ("lct_train_224", "frozen"),        # a step that returns its state
    ("lct_train_224", "half_batch"),    # the EF's mean over half a batch
    ("lct_train_224", "token"),         # the EF's sampled tokens altered
    ("vqa_answer_224", "answer"),       # each row's logits shifted
    ("vqa_serve_224", "answer"),
    ("ef_generate_224", "token"),       # each served token altered
])
def test_a_broken_timed_path_is_not_correct(cell, fault, cpu):
    r = run.execute(tiny_spec(cell), SEED, 1.0, False, cpu, fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["vqa_answer_224", "vqa_serve_224"])
def test_the_int8_control_is_not_correct(cell, cpu):
    """The W answerer's own int8 path in the program's place."""
    r = run.execute(tiny_spec(cell), SEED, 1.0, False, cpu, fault="int8")
    assert not r["correct"], r["checks"]


def test_the_float8_control_of_training_is_not_correct(cpu):
    spec = tiny_spec("lct_train_224")
    got = calibrate.readings(spec, SEED, cpu, 0.0, extra=("control",))
    assert run.judge(got["numbers"], spec["limits"]["numbers"])
    assert not run.judge(got["control"], spec["limits"]["numbers"])


def test_the_float8_control_of_generation_is_not_correct(cpu):
    spec = tiny_spec("ef_generate_224")
    got = calibrate.readings(spec, SEED, cpu, 0.5, extra=("control",))
    assert run.judge(got["numbers"], spec["limits"]["numbers"])
    assert not run.judge(got["control"], spec["limits"]["numbers"])


def test_the_training_reference_follows_its_own_numerics():
    """compare() reads 0 for a run against itself and a planted gap in
    each number it compares."""
    losses = [(1.0, 2.0)] * 3
    grads = {"ef": {"a": 1.0, "b": 2.0, "c": 0.0}, "w": {"d": 3.0}}
    import torch
    lp = torch.log_softmax(torch.randn(2, 4, 5), -1)
    toks = [lp.argmax(-1)] * 3
    want = {"losses": losses, "grads": grads, "changes": grads,
            "logp": [lp] * 3}
    same = train.compare({"losses": losses, "grads": grads,
                          "changes": grads, "pseudo": toks}, want)
    assert same["loss_gap"] == 0 and same["grad_gap_median"] == 0
    assert same["change_gap"] == 0
    off = {"ef": {"a": 1.5, "b": 2.0, "c": 5.0}, "w": {"d": 3.0}}
    moved = train.compare({"losses": [(1.1, 2.0)] * 3, "grads": off,
                           "changes": off, "pseudo": toks}, want)
    # leaf c has no reference gradient: it is left out
    assert moved["loss_gap"] == pytest.approx(0.1)
    assert moved["change_gap"] == pytest.approx(0.25)
    assert R.EXACT(torch.ones(1)).item() == 1.0
