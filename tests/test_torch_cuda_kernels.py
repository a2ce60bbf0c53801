"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Shapes are odd on purpose (hidden sizes that are not a multiple of
a warp, blocks whose thread count is not a power of two, the largest
hidden size a block takes), so that the kernels' edge handling is
exercised; chip_smoke.py checks the full-width shapes.

These tests need an NVIDIA GPU and nvcc, and skip elsewhere. This file
imports no JAX, so on a machine without it run it without the suite's
conftest:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda_kernels.py

Tolerances: fp32 h/c 1e-5 (summation order), bf16 operands 1e-3 (the
same, plus h values whose bf16 rounding a 1-ulp fp32 difference flips),
greedy tokens exact in fp32.
"""

import pytest
import torch

from lctvqa_torch.ops import _build, cuda_generate, cuda_lstm
from lctvqa_torch.ops.lstm import lstm_init
from lctvqa_torch.ops import nn as N

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
SHAPES = [(3, 5, 20, 48), (2, 4, 9, 80), (2, 3, 7, 1024),
          (1, 1, 300, 512)]  # B, T, E, H


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _weights(gen, e, h, dtype, device):
    lp = lstm_init(gen, e, h)["layers"][0]
    lp = {k: v.to(device) for k, v in lp.items()}
    return cuda_lstm.cell_weights(lp, dtype)


def _close(got, want, dtype):
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def _flat(out):
    """A kernel's outputs, nested tuples of tensors, as one flat tensor."""
    if isinstance(out, torch.Tensor):
        return out.flatten()
    return torch.cat([_flat(o) for o in out])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_lstm_kernels_match_plain(cuda, shape, dtype):
    b, t, e, h = shape
    gen = torch.Generator().manual_seed(0)
    w = _weights(gen, e, h, dtype, cuda)
    xs = torch.randn(b, t, e, generator=gen).to(cuda)
    h0 = (0.5 * torch.randn(b, h, generator=gen)).to(cuda)
    c0 = torch.randn(b, h, generator=gen).to(cuda)

    before = _build.launch_counts()
    got = cuda_lstm.lstm_cell(w, xs[:, 0], h0, c0)
    want = cuda_lstm.lstm_cell_plain(w, xs[:, 0], h0, c0)
    _close(got[0], want[0], dtype)
    _close(got[1], want[1], dtype)

    got = cuda_lstm.lstm_seq_final(w, xs)
    want = cuda_lstm.lstm_seq_final_plain(w, xs)
    _close(got[0], want[0], dtype)
    _close(got[1], want[1], dtype)

    got_o, (got_h, got_c) = cuda_lstm.lstm_seq(w, xs, h0, c0)
    want_o, (want_h, want_c) = cuda_lstm.lstm_seq_plain(w, xs, h0, c0)
    _close(got_o, want_o, dtype)
    _close(got_h, want_h, dtype)
    _close(got_c, want_c, dtype)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for name in ("lstm_cell", "lstm_seq_final", "lstm_seq_all"):
        assert after[name] == before[name] + 1


@pytest.mark.parametrize("shape", [(3, 5, 20, 48), (2, 4, 300, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_lstm_kernels_round_h_to_bf16(cuda, shape):
    """x = 0; h0 is 1 - 2^-10 on even units (bf16: 1) and -(0.5 + 2^-10)
    on odd ones (bf16: -0.5); W_hh rows are 2s and 4s, s = 512 // H. With
    h rounded to bf16 before the recurrent product every gate's recurrent
    sum is exactly 0, with h unrounded about -1.5 (-3sH/1024): the
    kernels must give the plain version's answer, which the unrounded
    one misses by far more than the tolerance."""
    b, t, e, h = shape
    w = _weights(torch.Generator().manual_seed(3), e, h, torch.bfloat16,
                 cuda)
    even = torch.arange(h, device=cuda) % 2 == 0
    h0 = torch.where(even, 1 - 2 ** -10, -(0.5 + 2 ** -10)).float()
    h0 = h0.expand(b, h).contiguous()
    c0 = torch.zeros_like(h0)
    s = max(1, 512 // h)
    w_hh = torch.where(even, 2.0 * s, 4.0 * s)[:, None].expand(h, 4 * h)
    probe = cuda_lstm.CellWeights(w.w_ih, w_hh.bfloat16().contiguous(), w.b)
    unrounded = cuda_lstm.CellWeights(w.w_ih.float(),
                                      w_hh.float().contiguous(), w.b)
    xs = torch.zeros(b, t, e, device=cuda)
    for kern, plain, args in (
            (cuda_lstm.lstm_cell, cuda_lstm.lstm_cell_plain,
             (xs[:, 0], h0, c0)),
            (cuda_lstm.lstm_seq_final, cuda_lstm.lstm_seq_final_plain,
             (xs, h0, c0)),
            (cuda_lstm.lstm_seq, cuda_lstm.lstm_seq_plain, (xs, h0, c0))):
        want = _flat(plain(probe, *args))
        _close(_flat(kern(probe, *args)), want, torch.bfloat16)
        ctl = _flat(plain(unrounded, *args))
        assert float((ctl - want).abs().max()) > 10 * TOL[torch.bfloat16]


@pytest.mark.parametrize("vocab,h", [(130, 48), (1000, 80)])
def test_generate_kernel_matches_plain(cuda, vocab, h):
    b, t, e = 5, 7, 24
    gen = torch.Generator().manual_seed(1)
    qst = {"word2vec": N.embedding_init(gen, vocab, e),
           "lstm": lstm_init(gen, e, h),
           "fc2": N.xavier_linear_init(gen, h, vocab)}
    qst = {k: {kk: (vv.to(cuda) if isinstance(vv, torch.Tensor) else
                    [{n: a.to(cuda) for n, a in lp.items()} for lp in vv])
               for kk, vv in v.items()} for k, v in qst.items()}
    img = N.l2_normalize(torch.randn(b, h, generator=gen)).to(cuda)
    before = _build.launch_counts()["greedy_generate"]
    got = cuda_generate.greedy_generate(qst, img, t, torch.float32)
    want = cuda_generate.greedy_generate_plain(qst, img, t, torch.float32)
    assert got.dtype == torch.int32 and got.shape == (b, t)
    assert torch.equal(got, want)
    assert _build.launch_counts()["greedy_generate"] == before + 1
    bf16 = cuda_generate.greedy_generate(qst, img, t, torch.bfloat16)
    assert bool(((bf16 >= 0) & (bf16 < vocab)).all())


def test_wrong_shapes_raise(cuda):
    gen = torch.Generator().manual_seed(2)
    w = _weights(gen, 20, 48, torch.float32, cuda)
    x = torch.randn(3, 21, device=cuda)
    h = torch.zeros(3, 48, device=cuda)
    with pytest.raises(ValueError, match="w_ih"):
        cuda_lstm.lstm_cell(w, x, h, h)
    big = _weights(gen, 20, 1056, torch.float32, cuda)
    with pytest.raises(ValueError, match="too large"):
        cuda_lstm.lstm_seq(big, torch.randn(1, 2, 20, device=cuda))
