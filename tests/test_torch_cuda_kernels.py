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
greedy tokens exact in fp32. BatchNorm: fp32 out 1e-5, bf16 out one bf16
ulp (2^-7 of the value). Mixed-op node: fp32 1e-5; bf16 4 * 2^-7 *
max|w| absolute (a flipped bf16 rounding of a stage output, see
chip_smoke.py).
"""

import pytest
import torch

from lctvqa_torch.models import search
from lctvqa_torch.ops import (_build, conv, cuda_bn, cuda_generate, cuda_lstm,
                              cuda_mixedop)
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


# C = 3 and 6 take the scalar path (not a multiple of 4), 20 leaves idle
# threads in a block, 1028 has more 4-channel groups than a block has lanes
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["to_float32", "to_bfloat16"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 7, 3), (2, 9, 4, 6), (5, 3, 3, 20),
                                   (64, 16, 16, 64), (1, 1, 1, 8),
                                   (2, 3, 5, 1028)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bn_kernel_matches_plain(cuda, shape, in_dtype, out_dtype):
    gen = torch.Generator().manual_seed(4)
    x = (1.5 * torch.randn(shape, generator=gen) + 0.3).to(cuda, in_dtype)
    before = _build.launch_counts()["bn_fwd"]
    got = cuda_bn.batchnorm_fwd(x, out_dtype=out_dtype)
    torch.cuda.synchronize()
    want = cuda_bn.batchnorm_plain(x, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == x.shape
    rtol = 1e-5 if out_dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5)
    assert _build.launch_counts()["bn_fwd"] == before + 1


def test_bn_switch_routes_cuda_tensors_to_the_kernel(cuda, monkeypatch):
    x = torch.randn(4, 6, 6, 8, device=cuda)
    before = _build.launch_counts()["bn_fwd"]
    conv.batchnorm({}, x)
    assert _build.launch_counts()["bn_fwd"] == before
    monkeypatch.setattr(conv, "USE_PALLAS_BN", True)
    got = conv.batchnorm({}, x, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _build.launch_counts()["bn_fwd"] == before + 1
    # an affine BN keeps the plain version
    affine = {k: v.to(cuda) for k, v in conv.batchnorm_init(8).items()}
    conv.batchnorm(affine, x)
    assert _build.launch_counts()["bn_fwd"] == before + 1


def _node_case(gen, n, h, w, c, k, edges, dtype, device):
    ops = []
    for _ in range(edges):
        p = search.mixed_op_init(gen, c, 1, k)
        ops.append({prim: {name: {"w": conv_p["w"].to(device)}
                           for name, conv_p in sub.items()}
                    for prim, sub in p.items()})
    xs = [torch.randn(n, h, w, c, generator=gen).to(device, dtype)
          for _ in range(edges)]
    wts = (torch.softmax(torch.randn(edges, 8, generator=gen), 1)
           * torch.softmax(torch.randn(edges, generator=gen), 0)[:, None])
    return xs, ops, wts.to(device)


# odd H x W (tiles that overhang the image), Cs from 1 to 24 (the larger
# take the 8 x 8 tile), N = 1, and nine edges (more than one launch takes)
NODE_CASES = [(3, 7, 9, 4, 4, 2), (1, 17, 5, 8, 4, 1), (2, 16, 16, 12, 4, 3),
              (2, 33, 18, 20, 4, 5), (3, 6, 6, 64, 4, 2), (2, 9, 7, 48, 2, 2),
              (1, 5, 4, 8, 4, 9), (2, 1, 1, 8, 4, 1)]  # N, H, W, C, k, E


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", NODE_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mixed_node_kernel_matches_plain(cuda, case, dtype):
    n, h, w, c, k, edges = case
    cs = c // k
    xs, ops, wts = _node_case(torch.Generator().manual_seed(5), n, h, w, c, k,
                              edges, dtype, cuda)
    launches = -(-edges // 8)
    before = _build.launch_counts()["mixed_node_fwd"]
    got = cuda_mixedop.mixed_node(xs, ops, wts, cs)
    torch.cuda.synchronize()
    want = cuda_mixedop.mixed_node_plain(
        xs, [cuda_mixedop.node_weights(p) for p in ops], wts, cs)
    assert got.shape == (n, h, w, cs) and got.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=4 * 2.0 ** -7 * float(wts.max()))
    assert _build.launch_counts()["mixed_node_fwd"] == before + launches


def test_mixed_node_kernel_reads_a_slice_through_strides(cuda):
    """Edge states that are views (a channel slice, a batch slice) of a
    wider tensor are read in place."""
    gen = torch.Generator().manual_seed(6)
    xs, ops, wts = _node_case(gen, 4, 9, 8, 16, 4, 2, torch.float32, cuda)
    wide = torch.randn(6, 9, 8, 24, generator=gen).to(cuda)
    views = [wide[1:5, :, :, 4:20], wide[2:6, :, :, 8:24]]
    assert not views[0].is_contiguous()
    got = cuda_mixedop.mixed_node(views, ops, wts, 4)
    want = cuda_mixedop.mixed_node([v.contiguous() for v in views], ops, wts,
                                   4)
    assert torch.equal(got, want)


def test_mixed_node_kernel_special_ops(cuda):
    """'none' alone gives exactly 0 and skip_connect alone gives w * x."""
    xs, ops, _ = _node_case(torch.Generator().manual_seed(7), 2, 6, 5, 8, 4,
                            1, torch.float32, cuda)
    only = torch.zeros(1, 8, device=cuda)
    only[0, 0] = 0.7
    assert not bool(cuda_mixedop.mixed_node(xs, ops, only, 2).any())
    only = torch.zeros(1, 8, device=cuda)
    only[0, 3] = 0.7
    torch.testing.assert_close(cuda_mixedop.mixed_node(xs, ops, only, 2),
                               0.7 * xs[0][..., :2], rtol=0, atol=1e-6)


def test_new_kernels_refuse_what_they_do_not_take(cuda):
    xs, ops, wts = _node_case(torch.Generator().manual_seed(8), 2, 4, 4, 8, 4,
                              1, torch.float32, cuda)
    with pytest.raises(ValueError, match="weights must be"):
        cuda_mixedop.mixed_node(xs, ops, wts[:, :7], 2)
    with pytest.raises(ValueError, match="channel stride"):
        cuda_mixedop.mixed_node([xs[0].transpose(2, 3)], ops, wts, 2)
    with pytest.raises(ValueError, match="too large"):
        wide, wide_ops, w1 = _node_case(torch.Generator().manual_seed(9), 1,
                                        2, 2, 130, 2, 1, torch.float32, cuda)
        cuda_mixedop.mixed_node(wide, wide_ops, w1, 65)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_bn.batchnorm_fwd(torch.zeros(2, 2, 2, 4, device=cuda,
                                          dtype=torch.float16))
