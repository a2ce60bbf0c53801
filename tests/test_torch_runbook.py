"""The data runbook on the port alone (the counterpart of
tests/test_runbook.py): raw VQA jsons and COCO-style JPEGs -> `python -m
lctvqa_torch.data.build` (vocab, images_h5, qa_h5, npy) ->
`lctvqa_torch.main --device cpu --tiny` for one epoch on the C++ core's
gathers (`--num_workers 2`) -> `lctvqa_torch.eval --device cpu` on one
batch. This file imports nothing of JAX or the JAX package.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from lctvqa_torch import eval as t_eval, main as t_main, native
from lctvqa_torch.data import synthetic

REPO = Path(__file__).resolve().parents[1]
CORRUPT = "COCO_train2014_000000009999.jpg"


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """One PyTorch intra-op thread, as tests/test_torch_train.py's fixture
    of that name (not imported: that file imports JAX)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def write_jpegs(raw, n_images: int):
    """Rectangular COCO-style JPEGs (the resize path runs) for the raw
    jsons' image ids, and one file that does not decode."""
    for si, split in enumerate(("train2014", "val2014")):
        d = raw / split
        d.mkdir()
        rng = np.random.RandomState(si)
        for i in range(n_images):
            arr = rng.randint(0, 256, (40, 52, 3), dtype=np.uint8)
            Image.fromarray(arr).save(
                d / f"COCO_{split}_{1000 * (si + 1) + i:012d}.jpg")
    (raw / "train2014" / CORRUPT).write_bytes(b"not a jpeg")


def test_port_runbook_full_chain(tmp_path, monkeypatch, capsys):
    raw = tmp_path / "raw"
    synthetic.write_raw_vqa_json(str(raw), num_images=6, num_questions=16)
    write_jpegs(raw, 6)

    out = tmp_path / "hdf5_32"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for argv in (["vocab", "--input_dir", str(raw), "--n_answers", "16"],
                 ["images_h5", "--train_dir", str(raw / "train2014"),
                  "--val_dir", str(raw / "val2014"), "--size", "32"],
                 ["qa_h5", "--input_dir", str(raw)],
                 ["npy", "--input_dir", str(raw), "--image_dir", str(raw)]):
        proc = subprocess.run(
            [sys.executable, "-m", "lctvqa_torch.data.build", *argv,
             "--output_dir", str(out)], env=env, capture_output=True,
            text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
    for f in ("vocab_questions.txt", "vocab_answers.txt", "vocab_unified.txt",
              "images.h5", "qst-ans.h5", "train.npy", "valid.npy"):
        assert (out / f).exists(), f

    # train: the LCT loop with the darts encoder, stage 3 included, on the
    # C++ core's gathers
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    exp = t_main.main(["--input_dir", str(out), "--exp", "runbook", "--tiny",
                       "--device", "cpu", "--img_size", "32",
                       "--batch_size", "8", "--num_epochs", "1",
                       "--arch_update_freq", "4", "--compute_dtype",
                       "float32", "--num_workers", "2"])
    assert exp.cfg.data.num_workers == 2 and native._lib is not None
    exp_dir = tmp_path / "experiment_data" / "runbook"
    assert (exp_dir / "ef_model.ckpt").exists()
    assert (exp_dir / "w_model.ckpt").exists()
    log = (exp_dir / "log.txt").read_text()
    assert "| TRAIN SET | STAGE3 |" in log and "BLEU4" in log

    # eval on the checkpoint
    capsys.readouterr()
    got = t_eval.main(["--exp", "runbook", "--input_dir", str(out),
                       "--root_stats_dir", str(tmp_path / "experiment_data"),
                       "--batch_size", "8", "--num_batches", "1",
                       "--device", "cpu"])
    assert got["n"] == 8 and 0.0 <= got["acc"] <= 1.0
    assert 0.0 <= got["bleu4"] <= 100.0
