"""The port's offline builders (lctvqa_torch/data/preprocess.py, build.py)
and download list (data/download.py) against the JAX package's, on the
same raw VQA jsons and COCO-style JPEGs: the vocabulary files byte for
byte, the h5 datasets, the resized images and the npy records equal.
Nothing here opens a URL.
"""

import filecmp
import os
import shutil
import subprocess
import sys
import zipfile

import h5py
import numpy as np
import pytest
from PIL import Image

from lctvqa.data import build as j_build, download as j_download
from lctvqa.data import preprocess as j_preprocess
from lctvqa_torch.data import build, download, preprocess, synthetic
from test_torch_runbook import CORRUPT, write_jpegs
from test_torch_train import REPO, one_cpu_thread  # noqa: F401 (autouse)

N_IMAGES = 6
VOCABS = ("vocab_questions.txt", "vocab_answers.txt", "vocab_unified.txt")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The raw inputs, and every subcommand's output of either package
    ({"raw", "port", "jax"}). The JAX package's images_h5 fails on a file
    it skips (it resizes a contiguous dataset), so it reads a copy of the
    JPEG directories without the corrupt file: what skipping it yields."""
    root = tmp_path_factory.mktemp("build")
    raw = root / "raw"
    synthetic.write_raw_vqa_json(str(raw), num_images=N_IMAGES,
                                 num_questions=16)
    write_jpegs(raw, N_IMAGES)
    clean = root / "clean"
    for split in ("train2014", "val2014"):
        shutil.copytree(raw / split, clean / split,
                        ignore=shutil.ignore_patterns(CORRUPT))
    out = {"raw": raw, "port": root / "port", "jax": root / "jax"}
    for pkg, main, jpegs in (("port", build.main, raw),
                             ("jax", j_build.main, clean)):
        o = str(out[pkg])
        main(["vocab", "--input_dir", str(raw), "--output_dir", o,
              "--n_answers", "12"])
        main(["images_h5", "--train_dir", str(jpegs / "train2014"),
              "--val_dir", str(jpegs / "val2014"), "--output_dir", o,
              "--size", "24"])
        main(["qa_h5", "--input_dir", str(raw), "--output_dir", o])
        main(["npy", "--input_dir", str(raw), "--image_dir", str(raw),
              "--output_dir", o])
        main(["resize", "--input_dir", str(raw), "--output_dir",
              str(out[pkg] / "resized"), "--size", "20"])
    return out


@pytest.mark.parametrize("name", VOCABS)
def test_vocab_files_are_the_jax_packages_bytes(built, name):
    assert filecmp.cmp(built["port"] / name, built["jax"] / name,
                       shallow=False)


def _datasets(path):
    with h5py.File(path, "r") as f:
        out = {}
        f.visititems(lambda k, v: out.__setitem__(k, v[()])
                     if isinstance(v, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("name", ["qst-ans.h5", "images.h5"])
def test_h5_files_hold_the_jax_packages_datasets(built, name):
    got = _datasets(built["port"] / name)
    want = _datasets(built["jax"] / name)
    assert sorted(got) == sorted(want) and len(got) in (4, 8)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_images_h5_skips_a_corrupt_file(built, capsys):
    """The corrupt file is skipped with a message and the split cut to
    the images kept, in sorted order."""
    got = _datasets(built["port"] / "images.h5")
    assert got["train/images"].shape == (N_IMAGES, 24, 24, 3)
    np.testing.assert_array_equal(got["train/coco_ids"],
                                  1000 + np.arange(N_IMAGES))
    out = built["port"] / "again"
    preprocess.build_images_h5({"train": str(built["raw"] / "train2014")},
                               str(out), size=8)
    assert f"skipping corrupt image {CORRUPT}" in capsys.readouterr().out
    assert _datasets(out / "images.h5")["train/images"].shape == (
        N_IMAGES, 8, 8, 3)


def test_qa_h5_dtypes_and_shapes(built):
    got = _datasets(built["port"] / "qst-ans.h5")
    assert {k: str(v.dtype) for k, v in got.items() if k.startswith(
        "train/")} == {"train/enc_qst": "int64", "train/qst_len": "uint8",
                       "train/enc_ans": "uint8", "train/img_id": "int32"}
    assert got["train/enc_qst"].shape == (16, 25)
    assert got["train/enc_ans"].shape == (16, 12)


def test_resize_writes_the_jax_packages_images(built):
    got = sorted(p.relative_to(built["port"] / "resized")
                 for p in (built["port"] / "resized").rglob("*.jpg"))
    want = sorted(p.relative_to(built["jax"] / "resized")
                  for p in (built["jax"] / "resized").rglob("*.jpg"))
    assert got == want and len(got) == 2 * N_IMAGES
    for rel in got:
        a = np.asarray(Image.open(built["port"] / "resized" / rel))
        b = np.asarray(Image.open(built["jax"] / "resized" / rel))
        assert a.shape == (20, 20, 3)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["train.npy", "valid.npy"])
def test_npy_records_are_the_jax_packages(built, name):
    got = np.load(built["port"] / name, allow_pickle=True).tolist()
    want = np.load(built["jax"] / name, allow_pickle=True).tolist()
    assert len(got) == 16 and got == want
    assert all(r["valid_answers"] for r in got)


def test_npy_records_fall_back_to_unk(tmp_path):
    """A question none of whose answers is in the vocabulary keeps
    ['<unk>'] as its valid answers, in both packages."""
    synthetic.write_raw_vqa_json(str(tmp_path), num_images=2,
                                 num_questions=4)
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "vocab_answers.txt").write_text("<unk>\n")
    preprocess.build_npy_inputs(str(tmp_path), str(tmp_path),
                                str(tmp_path / "port"))
    j_preprocess.build_npy_inputs(str(tmp_path), str(tmp_path),
                                  str(tmp_path / "jax"))
    for name in ("train.npy", "valid.npy"):
        got = np.load(tmp_path / "port" / name, allow_pickle=True).tolist()
        assert got == np.load(tmp_path / "jax" / name,
                              allow_pickle=True).tolist()
        assert all(r["valid_answers"] == ["<unk>"] for r in got)


# ---------------------------------------------------------------------------
# golden cases (tests/test_data.py's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,want", [("red, and black!", "red and black"),
                                    ("1,000", "1000"),
                                    ("no punctuation", "no punctuation"),
                                    ("it's (ok) ; yes", "it's ok  yes"),
                                    ("x-ray", "x ray"),
                                    ("2,3 dogs", "23 dogs"),
                                    ("t.v.", "t.v.")])
def test_process_punctuation_golden(s, want):
    assert preprocess.process_punctuation(s) == want
    assert j_preprocess.process_punctuation(s) == want


def test_encode_question_golden():
    t2i = {"<pad>": 0, "<unk>": 1, "<start>": 2, "<end>": 3, "cat": 5}
    vec, qlen = preprocess.encode_question(["cat", "zzz"], t2i, 6)
    np.testing.assert_array_equal(vec, [2, 5, 0, 3, 0, 0])
    assert vec.dtype == np.int64 and qlen == 3
    vec, qlen = preprocess.encode_question([], t2i, 6)
    np.testing.assert_array_equal(vec, [2, 3, 0, 0, 0, 0])
    assert qlen == 1
    with pytest.raises(ValueError, match="does not fit"):
        preprocess.encode_question(["cat"] * 5, t2i, 6)


def test_encode_answers_count_vector():
    vec = preprocess.encode_answers(["yes", "yes", "no", "zzz"],
                                    {"yes": 0, "no": 1})
    np.testing.assert_array_equal(vec, [2, 1])
    assert vec.dtype == np.uint8


def test_check_integrity_raises_on_misaligned_splits():
    q = {"questions": [{"question_id": 1, "image_id": 7}]}
    preprocess.check_integrity(q, {"annotations": [{"question_id": 1,
                                                    "image_id": 7}]})
    with pytest.raises(ValueError, match="not aligned"):
        preprocess.check_integrity(q, {"annotations": [
            {"question_id": 2, "image_id": 7}]})
    with pytest.raises(ValueError, match="don't match"):
        preprocess.check_integrity(q, {"annotations": [
            {"question_id": 1, "image_id": 8}]})


# ---------------------------------------------------------------------------
# without h5py and PIL (the card's machine)
# ---------------------------------------------------------------------------

NO_H5_PIL = """
import sys
for name in ("h5py", "PIL", "jax", "lctvqa"):
    sys.modules[name] = None      # any import of it raises ImportError
from lctvqa_torch.data import build
raw, out = sys.argv[1], sys.argv[2]
build.main(["vocab", "--input_dir", raw, "--output_dir", out,
            "--n_answers", "12"])
build.main(["npy", "--input_dir", raw, "--image_dir", raw,
            "--output_dir", out])
for cmd, needs in ((["images_h5", "--train_dir", raw, "--val_dir", raw],
                    "h5py"), (["qa_h5", "--input_dir", raw], "h5py"),
                   (["resize", "--input_dir", raw], "PIL")):
    try:
        build.main(cmd + ["--output_dir", out])
    except ImportError as e:
        assert needs in str(e), (cmd, e)
    else:
        raise AssertionError(f"{cmd[0]} ran without {needs}")
print("ok")
"""


def test_vocab_and_npy_need_neither_h5py_nor_pil(built, tmp_path):
    """With h5py and PIL unimportable, `vocab` and `npy` write the same
    files as with them, and images_h5, qa_h5 and resize raise ImportError
    naming the missing module."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", NO_H5_PIL, str(built["raw"]), str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    for name in VOCABS:
        assert filecmp.cmp(tmp_path / name, built["port"] / name,
                           shallow=False)
    for name in ("train.npy", "valid.npy"):
        assert (np.load(tmp_path / name, allow_pickle=True).tolist()
                == np.load(built["port"] / name, allow_pickle=True).tolist())


# ---------------------------------------------------------------------------
# download.py
# ---------------------------------------------------------------------------

def test_download_urls_are_the_jax_packages(capsys):
    assert download.VQA_URLS == j_download.VQA_URLS
    assert download.urls() == j_download.urls()
    assert len(download.urls()) == 8
    download.main(["--list_only"])
    assert capsys.readouterr().out.split() == j_download.urls()


def test_download_unzips_what_is_in_place_without_fetching(tmp_path,
                                                           monkeypatch):
    """Every zip already in place: nothing is fetched (urlretrieve is
    made to fail), each is unzipped where the JAX package unzips it."""
    def no_network(*args, **kwargs):
        raise AssertionError(f"fetched {args}")

    monkeypatch.setattr(download.urllib.request, "urlretrieve", no_network)
    for group, urls in download.VQA_URLS.items():
        dest = tmp_path / group if group != "Images" else tmp_path
        dest.mkdir(exist_ok=True)
        for url in urls:
            name = os.path.basename(url)
            with zipfile.ZipFile(dest / name, "w") as zf:
                zf.writestr(f"{name}.txt", url)
    download.download(str(tmp_path))
    assert (tmp_path / "Questions" /
            "v2_Questions_Val_mscoco.zip.txt").read_text().endswith(
        "v2_Questions_Val_mscoco.zip")
    assert (tmp_path / "train2014.zip.txt").exists()
