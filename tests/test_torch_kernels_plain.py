"""The port's four LSTM-family kernels (lctvqa_torch/ops/cuda_lstm.py,
cuda_generate.py) against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
Pallas kernels run in interpret mode (`force_interpret=True`), as
tests/test_pallas.py and tests/test_pallas_generate.py run them. Inputs
come from a seeded numpy generator and go to both. Tolerances: fp32 h/c
within 1e-5 (summation order); bf16 operands within 2e-2 (bf16 rounds
h at each step, and the two frameworks may round a value that lies on a
bf16 tie differently after a 1-ulp fp32 difference); greedy tokens exact.
The CUDA kernels themselves are checked on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lctvqa.config import small_test_config
from lctvqa.ops import pallas_generate as PG
from lctvqa.ops import pallas_lstm as PL
from lctvqa_torch.ops import _build, cuda_generate, cuda_lstm

MCFG = small_test_config().model
B, T = 4, MCFG.max_qst_len
E, H, V = MCFG.word_embed_size, MCFG.lstm_hidden_size, MCFG.qst_vocab_size

DTYPES = {"float32": (None, None, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _layer(rng):
    k = 1.0 / np.sqrt(H)
    return {"w_ih": rng.uniform(-k, k, (E, 4 * H)).astype(np.float32),
            "w_hh": rng.uniform(-k, k, (H, 4 * H)).astype(np.float32),
            "b_ih": rng.uniform(-k, k, (4 * H,)).astype(np.float32),
            "b_hh": rng.uniform(-k, k, (4 * H,)).astype(np.float32)}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cell_plain_matches_pallas(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    lp = _layer(rng)
    x, h, c = (rng.standard_normal((B, n)).astype(np.float32)
               for n in (E, H, H))
    want_h, want_c = PL.lstm_cell_pallas(_jax(lp), jnp.asarray(x),
                                         jnp.asarray(h), jnp.asarray(c),
                                         dtype=jdt, force_interpret=True)
    w = cuda_lstm.cell_weights(_torch(lp), tdt)
    got_h, got_c = cuda_lstm.lstm_cell(w, torch.from_numpy(x),
                                       torch.from_numpy(h),
                                       torch.from_numpy(c))
    _close(got_h, want_h, tol)
    _close(got_c, want_c, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_seq_final_plain_matches_pallas(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    lp = _layer(rng)
    xs = rng.standard_normal((B, T, E)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    w = cuda_lstm.cell_weights(_torch(lp), tdt)
    for init in (None, h0):  # zero state (the W encoder) and a given one
        want = PL.lstm_seq_final_pallas(
            _jax(lp), jnp.asarray(xs), None if init is None else
            jnp.asarray(init), None if init is None else jnp.asarray(init),
            dtype=jdt, force_interpret=True)
        t0 = None if init is None else torch.from_numpy(init)
        got = cuda_lstm.lstm_seq_final(w, torch.from_numpy(xs), t0, t0)
        _close(got[0], want[0], tol)
        _close(got[1], want[1], tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_seq_all_plain_matches_pallas(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    lp = _layer(rng)
    xs = rng.standard_normal((B, T, E)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    want_o, (want_h, want_c) = PL.lstm_seq_pallas(
        _jax(lp), jnp.asarray(xs), jnp.asarray(h0), jnp.asarray(h0),
        dtype=jdt, force_interpret=True)
    w = cuda_lstm.cell_weights(_torch(lp), tdt)
    got_o, (got_h, got_c) = cuda_lstm.lstm_seq(w, torch.from_numpy(xs),
                                               torch.from_numpy(h0),
                                               torch.from_numpy(h0))
    _close(got_o, want_o, tol)
    _close(got_h, want_h, tol)
    _close(got_c, want_c, tol)


def test_plain_rounds_h_to_bf16_as_pallas_does():
    """A probe on which rounding h to bf16 before the recurrent product
    decides the result: x = 0; h0 is 1 - 2^-10 on even units (bf16: 1)
    and -(0.5 + 2^-10) on odd ones (bf16: -0.5); W_hh rows are 2s and 4s,
    s = 512 / H. Every gate's recurrent sum is exactly 0 with h rounded
    and -3sH/1024 = -1.5 without. The plain versions give the Pallas
    kernels' answer; the same with h left unrounded (fp32 weights, as
    x = 0) does not."""
    _, _, tol = DTYPES["bfloat16"]
    rng = np.random.default_rng(6)
    lp = _layer(rng)
    even = np.arange(H) % 2 == 0
    s = max(1, 512 // H)
    lp["w_hh"] = np.repeat(np.where(even, 2.0 * s, 4.0 * s)[:, None], 4 * H,
                           axis=1).astype(np.float32)
    h0 = np.tile(np.where(even, 1 - 2 ** -10, -(0.5 + 2 ** -10)),
                 (B, 1)).astype(np.float32)
    xs = np.zeros((B, T, E), np.float32)
    want_o, want_hc = PL.lstm_seq_pallas(
        _jax(lp), jnp.asarray(xs), jnp.asarray(h0), jnp.zeros((B, H)),
        dtype=jnp.bfloat16, force_interpret=True)
    want_h, want_c = PL.lstm_cell_pallas(
        _jax(lp), jnp.asarray(xs[:, 0]), jnp.asarray(h0), jnp.zeros((B, H)),
        dtype=jnp.bfloat16, force_interpret=True)
    t = _torch({"xs": xs, "h0": h0})
    c0 = torch.zeros(B, H)
    for dtype, match in ((torch.bfloat16, True), (None, False)):
        w = cuda_lstm.cell_weights(_torch(lp), dtype)
        got_o, got_hc = cuda_lstm.lstm_seq(w, t["xs"], t["h0"], c0)
        got_h, got_c = cuda_lstm.lstm_cell(w, t["xs"][:, 0], t["h0"], c0)
        pairs = [(got_o, want_o), (got_h, want_h), (got_c, want_c),
                 *zip(got_hc, want_hc)]
        errs = [float(np.abs(g.numpy() - np.asarray(v)).max())
                for g, v in pairs]
        if match:
            for g, v in pairs:
                _close(g, v, tol)
        else:
            assert min(errs[:3]) > 5 * tol, errs


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_generate_plain_matches_pallas(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(3)
    bound = np.sqrt(6.0 / (H + V))
    qst = {"word2vec": {"table": rng.standard_normal((V, E))
                        .astype(np.float32)},
           "lstm": {"layers": [_layer(rng)]},
           "fc2": {"w": rng.uniform(-bound, bound, (H, V)).astype(np.float32),
                   "b": np.zeros(V, np.float32)}}
    img = rng.standard_normal((B, H)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    want = PG.greedy_generate_pallas(_jax(qst), jnp.asarray(img), T,
                                     dtype=jdt, force_interpret=True)
    got = cuda_generate.greedy_generate(_torch(qst), torch.from_numpy(img), T,
                                        dtype=tdt)
    assert got.dtype == torch.int32 and got.shape == (B, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(4)
    w = cuda_lstm.cell_weights(_torch(_layer(rng)), None)
    x = torch.from_numpy(rng.standard_normal((B, T, E)).astype(np.float32))
    h = torch.zeros(B, H)
    before = _build.launch_counts()
    got = cuda_lstm.lstm_cell(w, x[:, 0], h, h)
    want = cuda_lstm.lstm_cell_plain(w, x[:, 0], h, h)
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    cuda_lstm.lstm_seq(w, x)
    cuda_lstm.lstm_seq_final(w, x)
    assert _build.launch_counts() == before
    assert set(before) == {"lstm_cell", "lstm_seq_final", "lstm_seq_all",
                           "greedy_generate"}


def test_non_cpu_non_cuda_tensors_raise():
    """A wrapper never runs the plain version for a tensor off the CPU."""
    w = cuda_lstm.CellWeights(*(t.to("meta") for t in cuda_lstm.cell_weights(
        _torch(_layer(np.random.default_rng(5))), None)))
    x = torch.empty(B, E, device="meta")
    h = torch.empty(B, H, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lstm.lstm_cell(w, x, h, h)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lstm.lstm_seq(w, torch.empty(B, T, E, device="meta"), h, h)
