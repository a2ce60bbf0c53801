"""The port's CLI on two CPU ranks: `python -m lctvqa_torch.main
--num_devices 2 --device cpu` starts two gloo ranks, each on its half of
the global batch, and only rank 0 writes. The steps' numbers on several
ranks are held to one process's in tests/test_torch_parallel.py; here
the loops run end to end: an epoch, its checkpoints and log, a resumed
epoch whose checkpoints every rank reads, and the darts family.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from lctvqa_torch.data import synthetic
from lctvqa_torch.train import checkpoint

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    synthetic.make_dataset(str(d), num_images=8, num_questions=16,
                           img_size=32)
    return str(d)


def _main(cwd, *argv):
    """python -m lctvqa_torch.main --tiny --device cpu ... --num_devices 2,
    its ranks on one OpenMP thread each."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "lctvqa_torch.main", "--tiny", "--device",
         "cpu", "--img_size", "32", "--batch_size", "8", "--compute_dtype",
         "float32", "--num_devices", "2", *argv], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_cli_trains_on_two_ranks_and_resumes(synth, tmp_path):
    """An epoch of the LCT loop (stages 1 and 2, validation with BLEU4) on
    two ranks with the mixed-op node kernels (`--pallas_mixed_op`, whose
    statistics are the global batch's): one log, written by rank 0
    alone, that names the split; the checkpoints of both models with the
    mesh and the flag in their config; then --resume on two ranks
    continues from them, every rank reading them (the optimizers' steps
    go on from where the first run left them)."""
    argv = ("--input_dir", synth, "--skip_stage3", "--pallas_mixed_op",
            "--exp", "dp")
    _main(tmp_path, *argv, "--num_epochs", "1")
    out = tmp_path / "experiment_data" / "dp"
    log = (out / "log.txt").read_text()
    assert log.count("Exp Name: dp") == 1 and log.count("seed: 10") == 1
    assert "data parallel over 2 ranks: 4 rows a rank" in log
    assert "| VALID SET | Epoch [01/01], Loss:" in log and "BLEU4" in log
    state = checkpoint.load_state(str(out / "ef_model.ckpt"))
    # 16 training questions in global batches of 8: two steps
    assert state["epoch"] == 1 and state["ef_opt"]["step"] == 2
    assert state["config"]["mesh"]["num_devices"] == 2
    assert state["config"]["model"]["pallas_mixed_op"]
    assert sorted(p.name for p in out.iterdir() if p.suffix == ".ckpt") == [
        "ef_model.ckpt", "w_model.ckpt"]
    _main(tmp_path, *argv, "--num_epochs", "2", "--resume")
    state = checkpoint.load_state(str(out / "ef_model.ckpt"))
    assert state["epoch"] == 2 and state["ef_opt"]["step"] == 4
    assert (out / "log.txt").read_text().count(
        "| TRAIN SET | Epoch [02/02], EF-Loss:") == 1


def test_cli_darts_family_on_two_ranks(synth, tmp_path):
    """--package darts on two ranks: the arch step (the finite difference)
    and the train steps on the npy records, validation, rank 0's three
    checkpoints."""
    _main(tmp_path, "--input_dir", synth, "--package", "darts",
          "--num_epochs", "1", "--arch_update_freq", "2", "--exp", "dd")
    out = tmp_path / "experiment_data" / "dd"
    log = (out / "log.txt").read_text()
    assert log.count("| ARCH STEP | val-loss") == 1 and "| VAL |" in log
    assert {p.name for p in out.iterdir()} == {
        "vqa_model.ckpt", "arch_par.ckpt", "stats.ckpt", "log.txt"}
    assert checkpoint.load_state(str(out / "arch_par.ckpt"))[
        "arch_opt"]["step"] == 1
