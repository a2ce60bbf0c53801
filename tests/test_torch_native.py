"""The port's C++ data-loader core (lctvqa_torch/native) against the JAX
package's core and against its plain versions, and the port's loader on
the core against the JAX loader on its own.

The JAX core is compiled here from lctvqa/native/src/native.cpp into a
temporary directory with the port's g++ line, and the JAX package is
pointed at it (`lctvqa.native._LIB_PATH`): the library beside that source
is rewritten by tests/test_native.py, maybe in another worker meanwhile.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lctvqa import native as j_native, text as j_text
from lctvqa.data import pipeline as j_pipeline, synthetic as j_synthetic
from lctvqa_torch import native, text
from lctvqa_torch.data import pipeline, synthetic
from lctvqa_torch.native import build as nbuild
from test_torch_train import REPO, one_cpu_thread  # noqa: F401 (autouse)

TOKENIZE_CASES = [
    "What is the man holding?",
    "  Hello,   world!! ",
    "how many people are in the photo?",
    "Is this a cat's toy?",
    "a_b_c 123 x-y",
    "",
    "???",
    "¿Qué es esto?",
]


@pytest.fixture(scope="module")
def jax_core_path(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_core") / "liblctvqa_native.so"
    subprocess.run([nbuild.CXX, *nbuild.FLAGS, "-o", str(out),
                    str(REPO / "lctvqa" / "native" / "src" / "native.cpp")],
                   check=True)
    return str(out)


@pytest.fixture
def jax_core(jax_core_path, monkeypatch):
    """The JAX package's core, loaded from its copy in the temporary
    directory."""
    monkeypatch.setattr(j_native, "_LIB_PATH", jax_core_path)
    monkeypatch.setattr(j_native, "_lib", None)
    assert j_native.available()
    return j_native


def _enc_ans(seed, b, a):
    rng = np.random.default_rng(seed)
    enc = (rng.random((b, a)) < 0.3) * rng.integers(1, 4, (b, a))
    enc = enc.astype(np.uint8)
    enc[::5] = 0                  # rows with no valid answer
    return enc


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 62 - 1, 2 ** 64 - 1])
@pytest.mark.parametrize("a,max_num_ans", [(20, 10), (6, 10), (40, 3)])
def test_sample_answers_equal_the_jax_core_and_the_plain_version(
        jax_core, seed, a, max_num_ans):
    """Labels and multi-choice rows bit for bit: the port's core, the JAX
    package's and the plain splitmix64, for seeds up to 2**64 - 1, rows
    with no valid answer (labels <unk>, multi-choice all -1) and answer
    vocabularies narrower than max_num_ans."""
    enc = _enc_ans(seed % 1000, 37, a)
    got = native.sample_answers(enc, 1, seed, max_num_ans)
    want = jax_core.sample_answers(enc, 1, seed, max_num_ans)
    plain = native.sample_answers_plain(enc, 1, seed, max_num_ans)
    for g, w, p in zip(got, want, plain):
        assert g.dtype == w.dtype == p.dtype == np.int32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
    labels, mc = got
    assert (labels[::5] == 1).all() and (mc[::5] == -1).all()
    valid = enc > 0
    assert all(valid[i, labels[i]] for i in range(37) if valid[i].any())


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("row_shape", [(8, 8, 3), (128, 128, 3)])
def test_gather_rows_equal_the_jax_core_and_numpy(jax_core, threads,
                                                   row_shape):
    """24 rows of 192 bytes (one thread whatever is asked) and of 48 KiB
    (1.1 MiB: the threaded copy), repeated rows included."""
    rng = np.random.default_rng(len(row_shape) + threads)
    src = rng.integers(0, 256, (32,) + row_shape, dtype=np.uint8)
    rows = rng.integers(0, 32, 24).astype(np.int32)
    rows[:3] = 5
    got = native.gather_rows(src, rows, num_threads=threads)
    np.testing.assert_array_equal(
        got, jax_core.gather_rows(src, rows, num_threads=threads))
    np.testing.assert_array_equal(got, native.gather_rows_plain(src, rows))
    assert got.dtype == np.uint8 and got.shape == (24,) + row_shape


def test_gather_rows_checks_its_inputs():
    src = np.zeros((4, 3), np.uint8)
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([0, 4]))
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([-1]))
    with pytest.raises(ValueError, match="uint8"):
        native.gather_rows(src.astype(np.int32), np.array([0]))
    with pytest.raises(ValueError, match="C-contiguous"):
        native.gather_rows(np.zeros((4, 6), np.uint8)[:, ::2], np.array([0]))
    assert native.gather_rows(src, np.array([], np.int32)).shape == (0, 3)


@pytest.mark.parametrize("s", TOKENIZE_CASES)
def test_tokenize_equals_the_jax_core(jax_core, s):
    """The two cores' tokenizers agree, and agree with text.tokenize on
    ASCII. Bytes >= 0x80 are word characters in C++, so '¿' stays in its
    word, where Python's \\W splits it off (ROADMAP.md §3: no path uses the
    core's tokenizer)."""
    got = native.tokenize(s)
    assert got == jax_core.tokenize(s)
    if s.isascii():
        assert got == text.tokenize(s) == j_text.tokenize(s)
    else:
        assert got == ["¿qué", "es", "esto", "?"]
        assert text.tokenize(s) == ["¿", "qué", "es", "esto", "?"]


# ---------------------------------------------------------------------------
# the loader on the core
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def big_synth(tmp_path_factory):
    """The JAX package's make_dataset at 128 pixels: a batch of 24 is
    1.1 MiB of images, over the core's threading threshold."""
    d = str(tmp_path_factory.mktemp("synth128"))
    j_synthetic.make_dataset(d, num_images=8, num_questions=48,
                             img_size=128, n_answers=16)
    return d


@pytest.mark.parametrize("num_workers", [1, 3])
@pytest.mark.parametrize("batch_size", [16, 24])
def test_epoch_batches_equal_the_jax_loaders_on_its_core(
        jax_core, big_synth, num_workers, batch_size):
    """With both cores built, the port's epoch_batches and the JAX
    package's on the same directory and seed give the same batches, every
    key's values and dtypes, over a whole epoch; so do the plain versions
    from the same seed."""
    ours = pipeline.get_loader(big_synth, batch_size)["train"]
    theirs = j_pipeline.VqaH5Dataset(big_synth, "train")
    got = list(pipeline.epoch_batches(ours, batch_size,
                                      np.random.default_rng(7),
                                      num_workers=num_workers))
    want = list(j_pipeline.epoch_batches(theirs, batch_size,
                                         np.random.default_rng(7),
                                         num_workers=num_workers))
    plain = list(pipeline.epoch_batches_plain(ours, batch_size,
                                              np.random.default_rng(7)))
    assert len(got) == len(want) == len(plain) == 48 // batch_size
    for a, b, c in zip(got, want, plain):
        assert set(a) == set(b) == set(c)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)


def test_the_numpy_route_is_the_jax_loaders_without_its_core(jax_core,
                                                             big_synth):
    """use_native=False: the generator's own draws, as the JAX loader
    takes them with use_native=False (its image rows still by its core,
    the temporary copy)."""
    ours = pipeline.get_loader(big_synth, 8)["train"]
    theirs = j_pipeline.VqaH5Dataset(big_synth, "train")
    idx = np.array([3, 0, 17, 9, 9, 23, 1, 12])
    a = ours.gather(idx, np.random.default_rng(2), use_native=False)
    b = theirs.gather(idx, np.random.default_rng(2), use_native=False)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The core unloaded and a build directory of its own."""
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path / "native"


def test_a_failed_build_raises_and_nothing_falls_back(fresh_build,
                                                      monkeypatch):
    """A compiler that fails, or none: available() raises naming it, and
    the loader's gather raises with it instead of taking numpy."""
    ds = pipeline.loader_from_arrays(synthetic.make_arrays())["train"]
    monkeypatch.setattr(nbuild, "CXX", "false")
    with pytest.raises(RuntimeError, match="failed .code 1.: false -O3"):
        native.available()
    with pytest.raises(RuntimeError, match="failed"):
        ds.gather(np.arange(4), np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="failed"):
        ds._gather_images(np.arange(4))
    assert list(fresh_build.iterdir()) == []        # no partial library
    monkeypatch.setattr(nbuild, "CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="'no-such-compiler' was not "
                       "found"):
        native.available()
    assert native._lib is None


def test_the_build_is_named_by_its_inputs_and_done_once(fresh_build,
                                                        capsys):
    path = nbuild.build(verbose=True)
    assert path == nbuild.library_path() and path.parent == fresh_build
    assert capsys.readouterr().out.startswith("g++ -O3 -shared -fPIC "
                                              "-std=c++17 -pthread -o ")
    mtime = path.stat().st_mtime_ns
    assert nbuild.build() == path and path.stat().st_mtime_ns == mtime
    assert [p.name for p in fresh_build.iterdir()] == [path.name]
    assert native.available() and Path(native._lib._name) == path


def test_processes_building_at_once_share_one_library(fresh_build):
    """Four processes build into one empty directory at once: each gets
    the same whole library, and no temporary file is left."""
    code = ("import sys; from pathlib import Path; "
            "from lctvqa_torch.native import build as b; "
            "b.BUILD_DIR = Path(sys.argv[1]); print(b.build())")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(fresh_build)],
                              env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0] * 4
    assert len(set(outs)) == 1
    assert [p.name for p in fresh_build.iterdir()] == [Path(outs[0]).name]
    lib = ctypes.CDLL(outs[0])
    assert lib.lct_tokenize is not None


def test_the_build_command_builds_under_the_repo_root():
    """python -m lctvqa_torch.native.build: build/native/ at the repo
    root, from the port's own source."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "lctvqa_torch.native.build"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120, check=True)
    path = Path(proc.stdout.strip().splitlines()[-1].removeprefix("built "))
    assert path == nbuild.library_path() and path.exists()
    assert path.parent == REPO / "build" / "native"
    assert nbuild.SRC == REPO / "lctvqa_torch" / "native" / "src" / \
        "native.cpp"
    assert not proc.stderr
