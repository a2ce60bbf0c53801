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
chip_smoke.py). Backward kernels, each gradient against its own scale
s = max|plain|: bn_bwd 1e-5 s in fp32 and one bf16 ulp (2^-7 s) where dx
is bf16 (bn_bwd's s also counts max|g|: over a handful of rows dx is a
small remainder of g); mixed_node_bwd 1e-4 s in fp32 (two BatchNorm
backward passes deep), and in bf16 2^-7 s for dx (its one rounding) and
2e-3 s for the fp32 weight gradients (the plain version recomputes the
forward, and a stage output that the two round to different bf16
neighbours moves a few terms of a sum over all pixels). The LSTM Functions' gradients against
autograd through their plain versions: the same code after the forward,
so 1e-5 s in fp32 and 1e-3 s in bf16.
"""

import ctypes

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


def _seq_case(b, t, dtype, device, e=300, h=512, seed=30):
    gen = torch.Generator().manual_seed(seed)
    w = _weights(gen, e, h, dtype, device)
    xs = torch.tanh(torch.randn(b, t, e, generator=gen)).to(device)
    h0 = (0.5 * torch.randn(b, h, generator=gen)).to(device)
    c0 = torch.randn(b, h, generator=gen).to(device)
    return w, xs, h0, c0


# the sequence kernel's batch tiles hold 64 rows (fp32 at this width too):
# one row, a partial tile, one short of a tile, a full one, one over, and
# three tiles with a ragged last; a single step crosses no grid barrier
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("steps", [30, 1])
@pytest.mark.parametrize("b", [1, 8, 63, 64, 65, 130])
def test_lstm_seq_kernels_batch_tiles(cuda, b, steps, dtype):
    w, xs, h0, c0 = _seq_case(b, steps, dtype, cuda)
    for state in ((None, None), (h0, c0)):
        got_o, (got_h, got_c) = cuda_lstm.lstm_seq(w, xs, *state)
        want_o, (want_h, want_c) = cuda_lstm.lstm_seq_plain(w, xs, *state)
        assert got_o.shape == (b, steps, 512)
        _close(got_o, want_o, dtype)
        _close(got_h, want_h, dtype)
        _close(got_c, want_c, dtype)
        assert torch.equal(got_o[:, -1], got_h)
        fin_h, fin_c = cuda_lstm.lstm_seq_final(w, xs, *state)
        # the same kernel with and without the outputs: the same bits
        assert torch.equal(fin_h, got_h) and torch.equal(fin_c, got_c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_lstm_seq_kernel_calls_back_to_back(cuda, dtype):
    """Calls queued with no synchronize between them: each has its own
    barrier counter and exchange buffer, so none sees another's state;
    and two runs give the same bits."""
    w, xs, h0, c0 = _seq_case(64, 30, dtype, cuda)
    want = _flat(cuda_lstm.lstm_seq_plain(w, xs, h0, c0))
    outs = [cuda_lstm.lstm_seq(w, xs, h0, c0) for _ in range(2)]
    outs += [cuda_lstm.lstm_seq(w, xs, h0, c0) for _ in range(20)]
    torch.cuda.synchronize()
    first = _flat(outs[0])
    _close(first, want, dtype)
    for out in outs[1:]:
        assert torch.equal(_flat(out), first)
    # alternating shapes reuse nothing either
    small = _seq_case(3, 5, dtype, cuda, e=20, h=48)
    mixed = [cuda_lstm.lstm_seq(*args) for _ in range(5)
             for args in ((w, xs, h0, c0), small)]
    torch.cuda.synchronize()
    for out in mixed[0::2]:
        assert torch.equal(_flat(out), first)
    _close(_flat(mixed[1]), _flat(cuda_lstm.lstm_seq_plain(*small)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_lstm_seq_kernel_on_other_streams(cuda, dtype):
    """A call on a non-default stream, then two calls on two streams at
    once: each is a cooperative launch with its own scratch."""
    w, xs, h0, c0 = _seq_case(64, 30, dtype, cuda)
    other = _seq_case(8, 30, dtype, cuda, seed=31)
    want = _flat(cuda_lstm.lstm_seq_plain(w, xs, h0, c0))
    want_other = _flat(cuda_lstm.lstm_seq_plain(*other))
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    with torch.cuda.stream(s1):
        got = cuda_lstm.lstm_seq(w, xs, h0, c0)
    s1.synchronize()
    _close(_flat(got), want, dtype)
    outs1, outs2 = [], []
    for _ in range(5):
        with torch.cuda.stream(s1):
            outs1.append(cuda_lstm.lstm_seq(w, xs, h0, c0))
        with torch.cuda.stream(s2):
            outs2.append(cuda_lstm.lstm_seq_final(*other))
    torch.cuda.synchronize()
    for out in outs1:
        assert torch.equal(_flat(out), _flat(got))
    n = other[2].numel()
    for out in outs2:
        _close(_flat(out), want_other[-2 * n:], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("h", [48, 512, 576, 1024])
def test_lstm_seq_plan_on_the_card_is_the_python_mirror(cuda, h, dtype):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    got = cuda_lstm.seq_plan_on_device(h, dtype, cuda)
    want = cuda_lstm.seq_plan(h, dtype, sms)
    assert got == {k: want[k] for k in got}


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


# ---------------------------------------------------------------------------
# backward kernels and the autograd Functions
# ---------------------------------------------------------------------------

def _scaled_close(got, want, tol, what, floor=0.0):
    scale = float(want.float().abs().max()) + floor
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale + 1e-7, f"{what}: err {err}, scale {scale}"


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16],
                         ids=["g_float32", "g_bfloat16"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 7, 3), (2, 9, 4, 6), (5, 3, 3, 20),
                                   (64, 16, 16, 64), (1, 1, 2, 8),
                                   (2, 3, 5, 1028)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bn_bwd_kernel_matches_plain(cuda, shape, x_dtype, g_dtype):
    gen = torch.Generator().manual_seed(14)
    x = (1.5 * torch.randn(shape, generator=gen) + 0.3).to(cuda, x_dtype)
    g = torch.randn(shape, generator=gen).to(cuda, g_dtype)
    before = _build.launch_counts()
    xr = x.clone().requires_grad_()
    y = cuda_bn.batchnorm_fwd(xr, out_dtype=g_dtype)
    y.backward(g)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["bn_fwd"] == before["bn_fwd"] + 1
    assert after["bn_bwd"] == before["bn_bwd"] + 1
    want = cuda_bn.batchnorm_bwd_plain(x, g, cuda_bn.batchnorm_stats_plain(x))
    assert xr.grad.dtype == x_dtype and xr.grad.shape == x.shape
    # relative to dx's scale plus g's: dx is what is left of g after two
    # projections, and over a handful of rows (the 1x1x2 case) little is
    _scaled_close(xr.grad, want, 1e-5 if x_dtype == torch.float32
                  else 2.0 ** -7, "dx", floor=float(g.float().abs().max()))
    # the same inputs again give the same bits: no atomics
    xr2 = x.clone().requires_grad_()
    cuda_bn.batchnorm_fwd(xr2, out_dtype=g_dtype).backward(g)
    assert torch.equal(xr2.grad, xr.grad)


SYNC_KERNELS = ("bn_fwd_sums", "bn_fwd_apply", "bn_bwd_sums", "bn_bwd_apply")


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.bfloat16)],
                         ids=["float32", "float32_bfloat16", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 7, 3), (2, 9, 4, 6), (5, 3, 3, 20),
                                   (32, 16, 16, 64), (1, 1, 2, 8),
                                   (2, 3, 5, 1028)],
                         ids=lambda s: "x".join(map(str, s)))
def test_sync_bn_kernels_match_plain(cuda, shape, dtypes):
    """The two-launch mode's four kernels (several ranks' BatchNorm)
    against their plain versions: the sums 1e-5 of the sum of the terms'
    magnitudes; y and dx as the one-launch kernels' (dx, with this rank's
    own sums, is the ordinary backward). One launch each, the same bits
    twice."""
    x_dtype, o_dtype = dtypes
    gen = torch.Generator().manual_seed(24)
    x = (1.5 * torch.randn(shape, generator=gen) + 0.3).to(cuda, x_dtype)
    g = torch.randn(shape, generator=gen).to(cuda, o_dtype)
    c = shape[-1]
    m = x.numel() // c
    x32, g32 = x.float().reshape(-1, c), g.float().reshape(-1, c)
    before = _build.launch_counts()
    sums = cuda_bn.bn_sums(x)
    want = cuda_bn.bn_sums_plain(x)
    y, stat = cuda_bn.bn_fwd_apply(x, want, m, o_dtype)
    y_p, stat_p = cuda_bn.bn_fwd_apply_plain(x, want, m, o_dtype)
    bsums = cuda_bn.bn_bwd_sums(x, g, stat_p)
    bwant = cuda_bn.bn_bwd_sums_plain(x, g, stat_p)
    dx = cuda_bn.bn_bwd_apply(x, g, stat_p, bwant, m)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert all(after[k] == before[k] + 1 for k in SYNC_KERNELS)
    assert after["bn_fwd"] == before["bn_fwd"]
    xhat = (x32 - stat_p[0]) * stat_p[1]
    for got, ref, mag in ((sums, want, torch.stack([x32.abs().sum(0),
                                                    (x32 * x32).sum(0)])),
                          (bsums, bwant, torch.stack([
                              g32.abs().sum(0), (g32 * xhat).abs().sum(0)]))):
        assert bool(((got - ref).abs() <= 1e-5 * mag + 1e-30).all())
    assert y.dtype == o_dtype and y.shape == x.shape
    torch.testing.assert_close(stat, stat_p, rtol=1e-5, atol=0.0)
    rtol = 1e-5 if o_dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(y.float(), y_p.float(), rtol=rtol, atol=1e-5)
    _scaled_close(dx, cuda_bn.bn_bwd_apply_plain(x, g, stat_p, bwant, m),
                  1e-5 if x_dtype == torch.float32 else 2.0 ** -7, "dx",
                  floor=float(g.float().abs().max()))
    _scaled_close(dx, cuda_bn.batchnorm_bwd_plain(x, g, stat_p),
                  1e-5 if x_dtype == torch.float32 else 2.0 ** -7, "dx",
                  floor=float(g.float().abs().max()))
    again = (cuda_bn.bn_sums(x), cuda_bn.bn_fwd_apply(x, want, m, o_dtype)[0],
             cuda_bn.bn_bwd_sums(x, g, stat_p),
             cuda_bn.bn_bwd_apply(x, g, stat_p, bwant, m))
    assert all(torch.equal(a, b) for a, b in zip(again, (sums, y, bsums, dx)))


def test_bn_function_takes_the_two_launch_kernels_in_a_process_group(
        cuda):
    """With a process group (one gloo rank here) the BatchNorm Function
    launches the two-launch kernels and not the one-launch ones, and gives
    their results within 1e-5."""
    import socket

    from lctvqa_torch.parallel import distributed

    gen = torch.Generator().manual_seed(25)
    x = (1.5 * torch.randn(8, 16, 16, 32, generator=gen) + 0.3).to(cuda)
    g = torch.randn(x.shape, generator=gen).to(cuda)
    xr = x.clone().requires_grad_()
    cuda_bn.batchnorm_fwd(xr).backward(g)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    distributed.initialize(f"localhost:{port}", 1, 0, device=cuda,
                           backend="gloo")
    try:
        before = _build.launch_counts()
        xs = x.clone().requires_grad_()
        y = cuda_bn.batchnorm_fwd(xs)
        y.backward(g)
        torch.cuda.synchronize()
        after = _build.launch_counts()
    finally:
        distributed.shutdown()
    assert all(after[k] == before[k] + 1 for k in SYNC_KERNELS)
    assert after["bn_fwd"] == before["bn_fwd"]
    assert after["bn_bwd"] == before["bn_bwd"]
    torch.testing.assert_close(y, cuda_bn.batchnorm_fwd(x), rtol=1e-5,
                               atol=1e-5)
    _scaled_close(xs.grad, xr.grad, 1e-5, "dx")


def test_bn_function_is_first_order_only(cuda):
    x = torch.randn(2, 3, 3, 4, device=cuda, requires_grad=True)
    (dx,) = torch.autograd.grad(cuda_bn.batchnorm_fwd(x).square().sum(), x,
                                create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.sum().backward()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", NODE_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mixed_node_bwd_kernel_matches_plain(cuda, case, dtype):
    n, h, w, c, k, edges = case
    cs = c // k
    gen = torch.Generator().manual_seed(15)
    xs, ops, wts = _node_case(gen, n, h, w, c, k, edges, dtype, cuda)
    g = torch.randn(n, h, w, cs, generator=gen).to(cuda)
    nodes = [cuda_mixedop.node_weights(p) for p in ops]
    xg = [x.clone().requires_grad_() for x in xs]
    dws = [nw.dw.clone().requires_grad_() for nw in nodes]
    pws = [nw.pw.clone().requires_grad_() for nw in nodes]
    wg = wts.clone().requires_grad_()
    before = _build.launch_counts()["mixed_node_bwd"]
    out = cuda_mixedop.mixed_node(
        xg, [{"node": cuda_mixedop.NodeWeights(d, q)}
             for d, q in zip(dws, pws)], wg, cs)
    out.backward(g)
    torch.cuda.synchronize()
    assert (_build.launch_counts()["mixed_node_bwd"]
            == before + -(-edges // 8))
    dxs, ddw, dpw, dwt = cuda_mixedop.mixed_node_bwd_plain(xs, nodes, wts, g,
                                                           cs)
    fp32 = dtype == torch.float32
    for e in range(edges):
        assert xg[e].grad.dtype == dtype
        assert not bool(xg[e].grad[..., cs:].any())  # untouched channels
        _scaled_close(xg[e].grad[..., :cs], dxs[e],
                      1e-4 if fp32 else 2.0 ** -7, f"dx[{e}]")
    tol = 1e-4 if fp32 else 2e-3
    _scaled_close(torch.stack([d.grad for d in dws]), ddw, tol, "d dw")
    _scaled_close(torch.stack([q.grad for q in pws]), dpw, tol, "d pw")
    _scaled_close(wg.grad, dwt, tol, "d weights")
    assert not bool(wg.grad[:, 0].any())  # 'none'


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", [c for c in NODE_CASES if c[0] % 2 == 0],
                         ids=lambda s: "x".join(map(str, s)))
def test_mixed_node_sync_launches_on_two_halves_match_the_whole_batch(
        cuda, case, dtype):
    """The node kernels' data-parallel mode in one process: a SyncForward
    and a SyncBackward on each half of the batch, their sums added between
    the launches as two ranks' all-reduce adds them. The halves' outputs
    and dx together, and their weight-gradient shares summed, against the
    plain version on the whole batch (its inner ReLU decisions the
    kernels'), at the one-process kernel's tolerances; both halves hold
    the same statistics."""
    n, h, w, c, k, edges = case
    if edges > cuda_mixedop.MAX_EDGES:
        pytest.skip("one launch takes at most MAX_EDGES edges")
    cs = c // k
    gen = torch.Generator().manual_seed(17)
    xs, ops, wts = _node_case(gen, n, h, w, c, k, edges, dtype, cuda)
    g = torch.randn(n, h, w, cs, generator=gen).to(cuda)
    nodes = [cuda_mixedop.node_weights(p) for p in ops]
    halves = [slice(0, n // 2), slice(n // 2, n)]
    parts = [[x[r][..., :cs] for x in xs] for r in halves]

    def add(bufs):
        total = sum(b.clone() for b in bufs)
        for b in bufs:
            b.copy_(total)

    fwd = [cuda_mixedop.SyncForward(p, nodes, wts, cs, cuda, ranks=2)
           for p in parts]
    for step, part in (("a", slice(0, 2)), ("b", slice(2, None)),
                       ("z", None)):
        for f in fwd:
            getattr(f, step)()
        if part is not None:
            add([f.sums[part] for f in fwd])
    bwd = [cuda_mixedop.SyncBackward(p, nodes, wts, g[r].contiguous(),
                                     f.obuf, f.stat, cs, cuda, ranks=2)
           for p, r, f in zip(parts, halves, fwd)]
    for step, sums in (("r", "sums_r"), ("s", "sums_s"), ("x", None)):
        for b in bwd:
            getattr(b, step)()
        if sums is not None:
            add([getattr(b, sums) for b in bwd])
    outs = [b.outputs() for b in bwd]
    torch.cuda.synchronize()
    assert torch.equal(fwd[0].stat, fwd[1].stat)
    kept = (torch.cat([f.obuf[:2] for f in fwd], -1), fwd[0].stat)
    fp32 = dtype == torch.float32
    out = torch.cat([f.out for f in fwd])
    want = cuda_mixedop.mixed_node_plain(xs, nodes, wts, cs)
    if fp32:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    else:
        assert float((out - want).abs().max()) <= 4 * 2.0 ** -7 * float(
            wts.max())
    dxs, ddw, dpw, dwt = cuda_mixedop.mixed_node_bwd_plain(
        xs, nodes, wts, g, cs, kept=kept)
    for e in range(edges):
        got = torch.cat([o[0][e] for o in outs])
        assert got.dtype == dtype
        _scaled_close(got, dxs[e], 1e-4 if fp32 else 2.0 ** -7, f"dx[{e}]")
    tol = 1e-4 if fp32 else 2e-3
    for i, (name, full) in enumerate((("d dw", ddw), ("d pw", dpw),
                                      ("d weights", dwt))):
        _scaled_close(outs[0][i + 1] + outs[1][i + 1], full, tol, name)


def test_mixed_node_gradients_reach_the_conv_leaves_and_repeat(cuda):
    """Through node_weights' packing every conv leaf of every edge gets a
    gradient, equal to autograd's through the plain version; weights get
    one even where they are 0; a second run gives the same bits."""
    gen = torch.Generator().manual_seed(16)
    xs, ops, wts = _node_case(gen, 2, 9, 8, 16, 4, 3, torch.float32, cuda)
    wts[1] = 0.0
    g = torch.randn(2, 9, 8, 4, generator=gen).to(cuda)

    def run(fn):
        leaves = [c["w"].requires_grad_() for p in ops for sub in p.values()
                  for c in sub.values()]
        wg = wts.clone().requires_grad_()
        out = fn([x for x in xs], ops, wg)
        return torch.autograd.grad(out, leaves + [wg], g)

    kernel = lambda x, p, w: cuda_mixedop.mixed_node(x, p, w, 4)  # noqa: E731
    plain = lambda x, p, w: cuda_mixedop.mixed_node_plain(  # noqa: E731
        x, [cuda_mixedop.node_weights(q) for q in p], w, 4)
    got, again, want = run(kernel), run(kernel), run(plain)
    assert len(got) == 3 * 12 + 1
    for i, (a, b, c) in enumerate(zip(got, again, want)):
        assert torch.equal(a, b), i
        _scaled_close(a, c, 1e-4, f"leaf {i}")
    assert bool((got[-1][1, 1:].abs() > 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES[:3],
                         ids=lambda s: "x".join(map(str, s)))
def test_lstm_functions_grads_match_plain(cuda, shape, dtype):
    b, t, e, h = shape
    gen = torch.Generator().manual_seed(17)
    lp = {k: v.to(cuda) for k, v in lstm_init(gen, e, h)["layers"][0].items()}
    xs = torch.randn(b, t, e, generator=gen).to(cuda)
    h0 = (0.5 * torch.randn(b, h, generator=gen)).to(cuda)
    c0 = torch.randn(b, h, generator=gen).to(cuda)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    cases = {
        "lstm_cell": (lambda w, x, a, c: cuda_lstm.lstm_cell(w, x[:, 0], a, c),
                      lambda w, x, a, c: cuda_lstm.lstm_cell_plain(
                          w, x[:, 0], a, c)),
        "lstm_seq_final": (cuda_lstm.lstm_seq_final,
                           cuda_lstm.lstm_seq_final_plain),
        "lstm_seq_all": (cuda_lstm.lstm_seq, cuda_lstm.lstm_seq_plain),
    }
    for name, (kern, plain) in cases.items():
        grads = []
        before = _build.launch_counts()[name]
        for fn in (kern, plain):
            leaves = [v.clone().requires_grad_() for v in
                      (xs, h0, c0, *lp.values())]
            x, a, c = leaves[:3]
            w = cuda_lstm.cell_weights(dict(zip(lp, leaves[3:])), dtype)
            out = _flat(fn(w, x, a, c))
            gen.manual_seed(18)  # the same cotangent for both
            cot = torch.randn(out.shape, generator=gen).to(cuda)
            grads.append(torch.autograd.grad(out, leaves, cot))
        assert _build.launch_counts()[name] == before + 1
        for i, (a, c) in enumerate(zip(*grads)):
            _scaled_close(a, c, tol, f"{name} leaf {i}")


# ---------------------------------------------------------------------------
# the cell kernel: batch tiles, H not a multiple of its unit group, x in
# place, repeatability, streams, launch shape
# ---------------------------------------------------------------------------

CELL_SHAPES = [(300, 512), (30, 50)]  # E, H; 50 is no multiple of 4 or 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("eh", CELL_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("b", [1, 8, 64, 65, 130])
def test_lstm_cell_kernel_batch_tiles(cuda, b, eh, dtype):
    e, h = eh
    gen = torch.Generator().manual_seed(40)
    w = _weights(gen, e, h, dtype, cuda)
    xs = torch.randn(b, 3, e, generator=gen).to(cuda)
    h0 = (0.5 * torch.randn(b, h, generator=gen)).to(cuda)
    c0 = torch.randn(b, h, generator=gen).to(cuda)
    before = _build.launch_counts()["lstm_cell"]
    # x as a strided fp32 view, in the compute dtype, contiguous
    for x in (xs[:, 1], xs[:, 1].to(dtype), xs[:, 1].contiguous()):
        got = cuda_lstm.lstm_cell(w, x, h0, c0)
        want = cuda_lstm.lstm_cell_plain(w, x, h0, c0)
        _close(got[0], want[0], dtype)
        _close(got[1], want[1], dtype)
        # one [2, B, H] output
        assert got[1].data_ptr() == got[0].data_ptr() + b * h * 4
    torch.cuda.synchronize()
    assert _build.launch_counts()["lstm_cell"] == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_lstm_cell_kernel_repeats_and_runs_on_two_streams(cuda, dtype):
    """Two runs give the same bits (partial sums in a fixed order, no
    atomics); calls on two streams at once share nothing."""
    gen = torch.Generator().manual_seed(41)
    w = _weights(gen, 300, 512, dtype, cuda)
    args = [(torch.randn(b, 300, generator=gen).to(cuda),
             (0.5 * torch.randn(b, 512, generator=gen)).to(cuda),
             torch.randn(b, 512, generator=gen).to(cuda)) for b in (64, 8)]
    first = [_flat(cuda_lstm.lstm_cell(w, *a)) for a in args]
    for a, f in zip(args, first):
        _close(f, _flat(cuda_lstm.lstm_cell_plain(w, *a)), dtype)
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    outs = ([], [])
    for _ in range(10):
        for s, a, o in zip((s1, s2), args, outs):
            with torch.cuda.stream(s):
                o.append(_flat(cuda_lstm.lstm_cell(w, *a)))
    torch.cuda.synchronize()
    for f, o in zip(first, outs):
        assert all(torch.equal(v, f) for v in o)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("eh", CELL_SHAPES + [(300, 1024), (7, 1024)],
                         ids=lambda s: "x".join(map(str, s)))
def test_lstm_cell_plan_on_the_card_is_the_python_mirror(cuda, eh, dtype):
    got = cuda_lstm.cell_plan_on_device(*eh, dtype, cuda)
    smem = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    want = cuda_lstm.cell_plan(*eh, dtype, smem)
    assert got == {k: want[k] for k in got}


# ---------------------------------------------------------------------------
# the node forward at the supernet's cell shapes
# ---------------------------------------------------------------------------

# H, W, C of the cells' states and the most stride-1 edges a node has there
CELL_NODES = {"cell0": (64, 64, 16, 5), "cell1": (32, 32, 32, 3),
              "cell2": (16, 16, 64, 3), "cell3": (16, 16, 64, 5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("cell", sorted(CELL_NODES))
def test_mixed_node_forward_with_and_without_grad(cuda, cell, dtype):
    """The same bits with and without a gradient (the call without one
    skips the autograd Function); the stage outputs and statistics the
    grad path keeps are what the backward reads: every statistic is the
    mean and 1/sqrt(var + eps) of its plane, and the backward kernel on
    them gives the plain version's gradients."""
    h, w, c, edges = CELL_NODES[cell]
    cs = c // 4
    gen = torch.Generator().manual_seed(42)
    xs, ops, wts = _node_case(gen, 4, h, w, c, 4, edges, dtype, cuda)
    nodes = [cuda_mixedop.node_weights(p) for p in ops]
    want = cuda_mixedop.mixed_node_plain(xs, nodes, wts, cs)
    before = _build.launch_counts()["mixed_node_fwd"]
    got = cuda_mixedop.mixed_node(xs, ops, wts, cs)
    with torch.no_grad():
        again = cuda_mixedop.mixed_node(xs, ops, wts, cs)
    xg = [x.clone().requires_grad_() for x in xs]
    out = cuda_mixedop.mixed_node(xg, ops, wts, cs)
    assert out.grad_fn is not None
    torch.cuda.synchronize()
    assert _build.launch_counts()["mixed_node_fwd"] == before + 3
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=0, atol=4 * 2.0 ** -7 * float(wts.max())))
    torch.testing.assert_close(got, want, **tol)
    assert torch.equal(got, again) and torch.equal(got, out)

    _, obuf, stat = cuda_mixedop.node_fwd_launch(
        [x[..., :cs] for x in xs], nodes, wts, cs, cuda)
    planes = obuf.float()
    mean = planes.mean(-1)
    var = (planes * planes).mean(-1) - mean * mean
    torch.testing.assert_close(stat[..., 0], mean, rtol=1e-4,
                               atol=1e-5 * float(planes.abs().max()))
    torch.testing.assert_close(stat[..., 1], torch.rsqrt(var + 1e-5),
                               rtol=1e-3, atol=0)
    g = torch.randn(out.shape, generator=gen).to(cuda)
    out.backward(g)
    dxs = cuda_mixedop.mixed_node_bwd_plain(xs, nodes, wts, g, cs)[0]
    for e in range(edges):
        _scaled_close(xg[e].grad[..., :cs], dxs[e],
                      1e-4 if dtype == torch.float32 else 2.0 ** -7,
                      f"dx[{e}]")


def test_mixed_node_launch_shape_mirror(cuda):
    lib = _build.library()
    assert lib.lctvqa_mixed_node_max_edges() == cuda_mixedop.MAX_EDGES
    assert lib.lctvqa_mixed_node_max_cs() == cuda_mixedop.MAX_CS
    for cs in (1, 4, 5, 16, 17, 64):
        assert lib.lctvqa_mixed_node_fwd_tile(cs) == cuda_mixedop.node_tile(cs)


# ---------------------------------------------------------------------------
# the decode's cooperative grid and the node backward's three launches
# ---------------------------------------------------------------------------

def _decode_case(gen, e, h, vocab, device):
    qst = {"word2vec": N.embedding_init(gen, vocab, e),
           "lstm": lstm_init(gen, e, h),
           "fc2": N.xavier_linear_init(gen, h, vocab)}
    return {k: {kk: (vv.to(device) if isinstance(vv, torch.Tensor) else
                     [{n: a.to(device) for n, a in lp.items()} for lp in vv])
                for kk, vv in v.items()} for k, v in qst.items()}


def _first_gaps(qst, img, got, want, dtype):
    """Plain logit gap between the plain and the kernel token at the first
    step where a row's tokens differ (the plain decode, teacher-forced)."""
    from lctvqa_torch.models.qst_encoder import START_TOKEN

    w = cuda_lstm.cell_weights(qst["lstm"]["layers"][0], dtype)
    gaps = []
    for r in torch.nonzero((got != want).any(1)).flatten().tolist():
        t = int(torch.nonzero(got[r] != want[r])[0])
        h = c = img[r][None].float()
        x = torch.tanh(N.embed(qst["word2vec"],
                               torch.tensor([START_TOKEN], device=img.device)))
        for s in range(t + 1):
            h, c = cuda_lstm.lstm_cell_plain(w, x, h, c)
            if s < t:
                x = N.embed(qst["word2vec"], want[r, s:s + 1].long())
        logits = N.linear(qst["fc2"], torch.tanh(h), dtype=dtype)[0]
        gaps.append(float(logits[want[r, t]] - logits[got[r, t]]))
    return gaps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 8, 63, 64, 65, 130])
def test_generate_kernel_batch_tiles_at_full_width(cuda, b, dtype):
    """Tokens equal to the plain decode's at E 300, H 512, V 8192, T 30
    (in bf16 a differing token must be a near tie: plain logit gap within
    1e-3), whatever the number of batch tiles."""
    gen = torch.Generator().manual_seed(40)
    qst = _decode_case(gen, 300, 512, 8192, cuda)
    img = N.l2_normalize(torch.randn(b, 512, generator=gen)).to(cuda)
    got = cuda_generate.greedy_generate(qst, img, 30, dtype)
    want = cuda_generate.greedy_generate_plain(qst, img, 30, dtype)
    assert got.shape == (b, 30) and got.dtype == torch.int32
    gaps = _first_gaps(qst, img, got, want, dtype)
    if dtype == torch.float32:
        assert not gaps
    else:
        assert all(g <= 1e-3 for g in gaps), gaps


def test_generate_kernel_ties_go_to_the_lowest_column(cuda):
    """Two equal head columns in different head blocks' slices, above all
    others: every token is the lower one."""
    gen = torch.Generator().manual_seed(41)
    qst = _decode_case(gen, 300, 512, 8192, cuda)
    plan = cuda_generate.generate_plan(
        300, 512, 8192, torch.bfloat16,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    lo, hi = 5, 5 + 3 * plan["head_cols"]
    qst["fc2"]["w"][:, hi] = qst["fc2"]["w"][:, lo]
    qst["fc2"]["b"][lo] = qst["fc2"]["b"][hi] = 1e4
    img = N.l2_normalize(torch.randn(9, 512, generator=gen)).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        got = cuda_generate.greedy_generate(qst, img, 7, dtype)
        assert bool((got == lo).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_generate_kernel_repeats_back_to_back_and_on_another_stream(cuda,
                                                                    dtype):
    gen = torch.Generator().manual_seed(42)
    qst = _decode_case(gen, 300, 512, 8192, cuda)
    qst = dict(qst, decode=cuda_generate.decode_weights(qst, dtype))
    img = N.l2_normalize(torch.randn(70, 512, generator=gen)).to(cuda)
    first = cuda_generate.greedy_generate(qst, img, 30, dtype)
    again = [cuda_generate.greedy_generate(qst, img, 30, dtype)
             for _ in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = cuda_generate.greedy_generate(qst, img, 30, dtype)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(first, a) for a in again)
    assert torch.equal(first, other)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("ehv", [(300, 512, 8192), (24, 48, 136),
                                 (20, 80, 1000)],
                         ids=lambda s: "x".join(map(str, s)))
def test_generate_plan_on_the_card_is_the_python_mirror(cuda, ehv, dtype):
    props = torch.cuda.get_device_properties(cuda)
    got = cuda_generate.generate_plan_on_device(*ehv, dtype, cuda)
    want = cuda_generate.generate_plan(*ehv, dtype,
                                       props.multi_processor_count,
                                       props.shared_memory_per_block_optin)
    assert got == want


@pytest.mark.parametrize("edges", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_mixed_node_bwd_overhanging_tiles_and_edge_counts(cuda, dtype, edges):
    """A 9 x 7 plane (a 32 x 32 tile at Cs 4 overhangs it), N = 1, every
    edge count one launch takes; two calls give the same bits."""
    gen = torch.Generator().manual_seed(43)
    xs, ops, wts = _node_case(gen, 1, 9, 7, 16, 4, edges, dtype, cuda)
    nodes = [cuda_mixedop.node_weights(p) for p in ops]
    xs = [x[..., :4] for x in xs]
    g = torch.randn(1, 9, 7, 4, generator=gen).to(cuda)
    _, obuf, stat = cuda_mixedop.node_fwd_launch(xs, nodes, wts, 4, cuda)
    got = cuda_mixedop.node_bwd_launch(xs, nodes, wts, g, obuf, stat, 4, cuda)
    again = cuda_mixedop.node_bwd_launch(xs, nodes, wts, g, obuf, stat, 4,
                                         cuda)
    want = cuda_mixedop.mixed_node_bwd_plain(xs, nodes, wts, g, 4)
    torch.cuda.synchronize()
    fp32 = dtype == torch.float32
    for e in range(edges):
        assert torch.equal(got[0][e], again[0][e])
        _scaled_close(got[0][e], want[0][e], 1e-4 if fp32 else 2.0 ** -7,
                      f"dx[{e}]")
    for i, what in ((1, "d dw"), (2, "d pw"), (3, "d weights")):
        assert torch.equal(got[i], again[i])
        _scaled_close(got[i], want[i], 1e-4 if fp32 else 2e-3, what)


def test_mixed_node_bwd_scratch_is_the_python_mirror(cuda):
    lib = _build.library()
    fn = lib.lctvqa_mixed_node_bwd_scratch
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    for e, n, h, w, c in ((5, 64, 64, 64, 4), (3, 64, 16, 16, 16),
                          (2, 3, 7, 9, 24), (8, 1, 9, 7, 64)):
        lay = cuda_mixedop.node_bwd_scratch(e, n, h, w, c, torch.float32)
        assert fn(e, n, h, w, c) * 4 == lay["total"] - lay["scratch"]


# the BatchNorm kernels' cooperative grid: the supernet's shapes, odd ones,
# repeatability, the barrier counter across calls and streams
# ---------------------------------------------------------------------------

BN_SHAPES = [(64, 64, 64, 16), (64, 64, 64, 32), (64, 32, 32, 64),
             (64, 16, 16, 64), (64, 32, 32, 8),
             (64, 16, 16, 16), (64, 32, 32, 32)]  # chip_smoke.BN_SHAPES
# M = 1 with C = 3 (the scalar path); an odd M with C = 12 (rows that are
# not a multiple of a block's, bf16 rows of 24 bytes: a block's share must
# start on 16); C = 4 with an odd last share (an 8-byte last copy in bf16);
# C = 1028 (more channel groups than lanes, more sums than threads)
BN_ODD_SHAPES = [(1, 1, 1, 3), (3, 37, 41, 12), (3, 49, 71, 4),
                 (2, 3, 5, 1028)]


def _bn_case(shape, x_dtype, g_dtype, device, seed=24):
    gen = torch.Generator().manual_seed(seed)
    x = (1.5 * torch.randn(shape, generator=gen) + 0.3).to(device, x_dtype)
    g = torch.randn(shape, generator=gen).to(device, g_dtype)
    return x, g


def _bn_plans_agree(device, x, other):
    c = x.shape[-1]
    props = torch.cuda.get_device_properties(device)
    for backward in (False, True):
        want = cuda_bn.bn_plan(x.numel() // c, c, x.dtype, other, backward,
                               props.multi_processor_count,
                               props.shared_memory_per_block_optin)
        got = cuda_bn.bn_plan_on_device(x.numel() // c, c, x.dtype, other,
                                        backward, device)
        assert got == {k: want[k] for k in got}, (backward, got, want)


@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16],
                         ids=["y_g_float32", "y_g_bfloat16"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BN_SHAPES + BN_ODD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_bn_kernels_match_plain_repeat_and_follow_the_plan(cuda, shape,
                                                           x_dtype, b_dtype):
    """Forward (y in b_dtype) and backward (g in b_dtype): the launch shape
    the card takes is bn_plan's, two calls give the same bits, and both
    match their plain versions at chip_smoke's tolerances."""
    x, g = _bn_case(shape, x_dtype, b_dtype, cuda)
    _bn_plans_agree(cuda, x, b_dtype)
    before = _build.launch_counts()
    y, stat, _ = cuda_bn.batchnorm_fwd_stat(x, b_dtype)
    y2, stat2, _ = cuda_bn.batchnorm_fwd_stat(x, b_dtype)
    dx = cuda_bn.batchnorm_bwd(x, g, stat)
    dx2 = cuda_bn.batchnorm_bwd(x, g, stat)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["bn_fwd"] == before["bn_fwd"] + 2
    assert after["bn_bwd"] == before["bn_bwd"] + 2
    assert torch.equal(y, y2) and torch.equal(stat, stat2)
    assert torch.equal(dx, dx2)
    want = cuda_bn.batchnorm_plain(x, out_dtype=b_dtype)
    assert y.dtype == b_dtype and y.shape == x.shape
    torch.testing.assert_close(
        y.float(), want.float(), atol=1e-5,
        rtol=1e-5 if b_dtype == torch.float32 else 2.0 ** -7)
    dwant = cuda_bn.batchnorm_bwd_plain(x, g,
                                        cuda_bn.batchnorm_stats_plain(x))
    assert dx.dtype == x_dtype and dx.shape == x.shape
    _scaled_close(dx, dwant, 1e-5 if x_dtype == torch.float32 else 2.0 ** -7,
                  "dx", floor=float(g.float().abs().max()))


@pytest.mark.parametrize("shape", [(64, 32, 32, 8), (64, 64, 64, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bn_kernels_back_to_back_and_on_two_streams(cuda, shape):
    """Each call zeroes its own barrier counter in its own scratch: calls
    back to back on one stream and interleaved on two streams give the
    bits of a lone call."""
    x, g = _bn_case(shape, torch.float32, torch.bfloat16, cuda, seed=25)
    y0, stat0, _ = cuda_bn.batchnorm_fwd_stat(x, torch.bfloat16)
    dx0 = cuda_bn.batchnorm_bwd(x, g, stat0)
    torch.cuda.synchronize()

    def calls(n):
        out = []
        for _ in range(n):
            y, stat, _ = cuda_bn.batchnorm_fwd_stat(x, torch.bfloat16)
            out.append((y, stat, cuda_bn.batchnorm_bwd(x, g, stat)))
        return out

    runs = calls(6)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(3):
        for s in streams:
            with torch.cuda.stream(s):
                runs += calls(1)
    torch.cuda.synchronize()
    for y, stat, dx in runs:
        assert torch.equal(y, y0) and torch.equal(stat, stat0)
        assert torch.equal(dx, dx0)


def _chip_smoke():
    """chip_smoke.py at the repo root, for its input draws."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_node_bwd_on_the_draw_with_relu_ties(cuda, dtype):
    """cell0 of chip_smoke's second node-backward draw (N = 1, 64; E = 3,
    5), where an inner ReLU input of edge 2 lies within an ulp of 0 and the
    kernel's stored forward and the plain version's recomputed one decide
    it differently: the kernel against the plain backward that takes the
    kernel's decisions, at chip_smoke's tolerances."""
    smoke = _chip_smoke()
    seen = 0
    for cell, n, edges, dname, xs, nodes, wts, g in smoke.node_bwd_cases(
            cuda, smoke.NODE_BWD_FAULT_DRAW):
        if cell != "cell0":
            break
        if dname != dtype:
            continue
        cs = xs[0].shape[-1]
        _, obuf, stat = cuda_mixedop.node_fwd_launch(xs, nodes, wts, cs, cuda)
        got = cuda_mixedop.node_bwd_launch(xs, nodes, wts, g, obuf, stat, cs,
                                           cuda)
        want = cuda_mixedop.mixed_node_bwd_plain(xs, nodes, wts, g, cs,
                                                 kept=(obuf, stat))
        torch.cuda.synchronize()
        fp32 = dtype == "float32"
        for e in range(edges):
            _scaled_close(got[0][e], want[0][e], 1e-4 if fp32 else 2.0 ** -7,
                          f"N={n} E={edges} dx[{e}]")
        for i, what in ((1, "d dw"), (2, "d pw"), (3, "d weights")):
            _scaled_close(got[i], want[i], 1e-4 if fp32 else 2e-3,
                          f"N={n} E={edges} {what}")
        seen += 1
    assert seen == 4


# ---------------------------------------------------------------------------
# the operators (`lctvqa_torch::*`, the served calls' route)
# ---------------------------------------------------------------------------

OPS = ("lstm_cell", "lstm_seq_final", "lstm_seq", "greedy_generate",
       "mixed_node", "batchnorm")


def _op_case(name, dtype, device, wanted=False):
    """(operator, its arguments on `device`, its plain version on them):
    serving shapes cut to odd sizes. `wanted` makes a weight require a
    gradient, which opcheck's autograd test needs."""
    gen = torch.Generator().manual_seed(11)
    b, t, e, h = 5, 6, 20, 48

    def grad(tensor):
        return tensor.clone().requires_grad_() if wanted else tensor

    if name in ("lstm_cell", "lstm_seq_final", "lstm_seq"):
        w = _weights(gen, e, h, dtype, device)
        w = cuda_lstm.CellWeights(grad(w.w_ih), w.w_hh, w.b)
        xs = torch.randn(b, t, e, generator=gen).to(device)
        h0 = (0.5 * torch.randn(b, h, generator=gen)).to(device)
        c0 = (0.5 * torch.randn(b, h, generator=gen)).to(device)
        if name == "lstm_cell":
            return (cuda_lstm.LSTM_CELL_OP, (xs[:, 0], h0, c0, *w),
                    lambda: torch.stack(cuda_lstm.lstm_cell_plain(
                        w, xs[:, 0], h0, c0)))
        if name == "lstm_seq_final":
            return (cuda_lstm.LSTM_SEQ_FINAL_OP, (xs, h0, c0, *w),
                    lambda: cuda_lstm.lstm_seq_final_plain(w, xs, h0, c0))
        return (cuda_lstm.LSTM_SEQ_OP, (xs, h0, c0, *w),
                lambda: cuda_lstm._seq_all_plain(w, xs, h0, c0))
    if name == "greedy_generate":
        vocab = 130
        qst = {"word2vec": N.embedding_init(gen, vocab, e),
               "lstm": lstm_init(gen, e, h),
               "fc2": N.xavier_linear_init(gen, h, vocab)}
        qst = {k: {kk: (vv.to(device) if isinstance(vv, torch.Tensor) else
                        [{n: a.to(device) for n, a in lp.items()}
                         for lp in vv])
                   for kk, vv in v.items()} for k, v in qst.items()}
        img = N.l2_normalize(torch.randn(b, h, generator=gen)).to(device)
        d = cuda_generate.decode_weights(qst, dtype)
        args = (img, d.x0, grad(d.cell.w_ih), d.cell.w_hh, d.cell.b, d.fc2_w,
                d.fc2_b, d.table, t)
        return (cuda_generate.GREEDY_GENERATE_OP, args,
                lambda: cuda_generate.greedy_generate_plain(qst, img, t,
                                                            dtype), qst)
    if name == "mixed_node":
        xs, ops, wts = _node_case(gen, 3, 7, 9, 8, 4, 3, dtype, device)
        nodes = [cuda_mixedop.node_weights(p) for p in ops]
        args = ([grad(x) for x in xs], [n.dw for n in nodes],
                [n.pw for n in nodes], wts, 2)
        return (cuda_mixedop.MIXED_NODE_OP, args,
                lambda: cuda_mixedop.mixed_node_plain(xs, nodes, wts, 2))
    x = (1.5 * torch.randn(3, 5, 7, 20, generator=gen) + 0.3).to(device,
                                                                  dtype)
    return (cuda_bn.BATCHNORM_OP, (grad(x), dtype, 1e-5),
            lambda: cuda_bn.batchnorm_plain(x, 1e-5, dtype))


@pytest.mark.parametrize("name", OPS)
def test_operator_opcheck_on_the_card(cuda, name):
    """The schema, the fake against the CUDA implementation (the kernel),
    autograd's registration and AOT dispatch with dynamic shapes."""
    op, args = _op_case(name, torch.bfloat16, cuda, wanted=True)[:2]
    import warnings

    with warnings.catch_warnings():
        # the AOT check backprops through the operator, which has no
        # autograd kernel: PyTorch warns, and no gradient is compared
        warnings.filterwarnings("ignore", ".*an autograd kernel was not")
        torch.library.opcheck(op, args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", OPS)
def test_operator_matches_plain_on_the_card(cuda, name, dtype):
    """Each operator on CUDA tensors launches its kernel once and agrees
    with its plain version at chip_smoke's phase-2 limits: LSTM h/c
    (TOL), greedy tokens exactly in fp32 and in bf16 but at a near tie
    (plain logits within 1e-3), the node's fp32 1e-5 and bf16 4 * 2^-7 *
    max|w|, BatchNorm's 1e-5 and one bf16 ulp."""
    case = _op_case(name, dtype, cuda)
    op, args, plain = case[:3]
    kernel = {"lstm_seq": "lstm_seq_all", "mixed_node": "mixed_node_fwd",
              "batchnorm": "bn_fwd"}.get(name, name)
    before = _build.launch_counts()[kernel]
    got = op(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts()[kernel] == before + 1
    want = plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert [g.dtype for g in got] == [w.dtype for w in want]
    for g, w in zip(got, want):
        if name.startswith("lstm"):
            _close(g, w, dtype)
        elif name == "greedy_generate":
            gaps = _chip_smoke()._token_gaps(case[3], args[0], g, w, dtype)
            assert not gaps or (dtype == torch.bfloat16
                                and max(gaps) <= 1e-3), gaps
        elif name == "mixed_node":
            tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
                   else dict(rtol=0, atol=4 * 2.0 ** -7
                             * float(args[3].max())))
            torch.testing.assert_close(g, w, **tol)
        else:
            rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                       atol=1e-5)


# (N, H, W, C) of the VGG epilogue: odd sizes (floor-mode pools), the
# fewest channels the kernel takes, a count of lanes that does not divide
# its 256 threads, the most channels
VGG_SHAPES = [(3, 7, 5, 8), (2, 9, 10, 24), (2, 33, 31, 64), (1, 4, 6, 2048)]
VGG_DTYPES = [(torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32),
              (torch.float32, torch.float32)]


@pytest.mark.parametrize("pool", [False, True], ids=["relu", "pool"])
@pytest.mark.parametrize("dtypes", VGG_DTYPES, ids=lambda d: "-".join(
    str(t).replace("torch.", "") for t in d))
@pytest.mark.parametrize("shape", VGG_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_vgg_epilogue_matches_plain(cuda, shape, dtypes, pool):
    """The operator on the card launches the kernel once and equals its
    plain version bit for bit, in the output's dtype and shape."""
    from lctvqa_torch.ops import cuda_vgg

    in_dtype, out_dtype = dtypes
    gen = torch.Generator().manual_seed(sum(shape))
    y = torch.randn(*shape, generator=gen).to(cuda, in_dtype)
    b = (0.5 * torch.randn(shape[-1], generator=gen)).to(cuda)
    before = _build.launch_counts()["vgg_epilogue"]
    got = cuda_vgg.vgg_epilogue(y, b, pool, out_dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts()["vgg_epilogue"] == before + 1
    want = cuda_vgg.vgg_epilogue_plain(y, b, pool, out_dtype)
    assert got.dtype == want.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_vgg_epilogue_refuses_what_it_does_not_take(cuda):
    """C not a multiple of 8, a non-contiguous or unaligned y, fp16, a
    bias off the card, a pool of a single row, an fp32 y to bf16:
    ValueError, no launch."""
    from lctvqa_torch.ops import cuda_vgg

    y = torch.randn(2, 6, 6, 16, device=cuda)
    b = torch.randn(16, device=cuda)
    before = _build.launch_counts()["vgg_epilogue"]
    for args in ((torch.randn(2, 6, 6, 12, device=cuda), b[:12]),
                 (y.transpose(1, 2), b), (y.half(), b), (y, b.cpu()),
                 (y[:, :1], b)):
        with pytest.raises(ValueError, match="vgg_epilogue"):
            cuda_vgg.vgg_epilogue_cuda(*args, args[0].shape[1] == 1,
                                       torch.float32)
    unaligned = y.flatten()[2:2 + 2 * 6 * 6 * 8].view(2, 6, 6, 8)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_vgg.vgg_epilogue_cuda(unaligned, b[:8], False, torch.float32)
    with pytest.raises(ValueError, match="dtype or fp32"):
        cuda_vgg.vgg_epilogue_cuda(y, b, False, torch.bfloat16)
    assert _build.launch_counts()["vgg_epilogue"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_vgg_features_take_the_epilogue_on_the_card(cuda, dtype):
    """A no-grad VGG19 forward at the small test config launches 16
    epilogues and equals the composition (the same call with an image
    that needs a gradient, which keeps it) bit for bit."""
    from lctvqa_torch.models import vgg

    params = vgg.vgg19_init(torch.Generator().manual_seed(12), 0.125,
                            fc_dim=32)
    params = {"features": [{k: t.to(cuda) for k, t in p.items()}
                           for p in params["features"]],
              **{k: {kk: t.to(cuda) for kk, t in params[k].items()}
                 for k in ("fc6", "fc7")}}
    x = torch.randn(3, 40, 40, 3, generator=torch.Generator().manual_seed(
        13)).to(cuda)
    dt = None if dtype == torch.float32 else dtype
    before = _build.launch_counts()["vgg_epilogue"]
    with torch.no_grad():
        got = vgg.vgg19_features(params, x, dtype=dt)
    torch.cuda.synchronize()
    assert _build.launch_counts()["vgg_epilogue"] == before + 16
    want = vgg.vgg19_features(params, x.clone().requires_grad_(), dtype=dt)
    torch.cuda.synchronize()
    assert _build.launch_counts()["vgg_epilogue"] == before + 16
    assert torch.equal(got, want.detach())


@pytest.mark.parametrize("kn", [(75, 13), (512, 1024)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("m", [1, 16, 17, 64 * 49])
def test_int8_matmul_matches_plain(cuda, m, kn):
    """The card's int8 product (`torch._int_mm` on operands padded to M >
    16 and K, N multiples of 8, the output sliced back) against its plain
    version, bit for bit, on both sides of the row padding and at a
    conv's patch rows (B = 64 of 7x7 outputs); one launch a call."""
    from lctvqa_torch.ops import int8

    k, n = kn
    gen = torch.Generator().manual_seed(m + k)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=gen,
                      dtype=torch.int8).t()  # column-major, as weights are
    before = int8.LAUNCHES["int8_matmul"]
    got = int8.int8_matmul(a.to(cuda), b.to(cuda))
    assert int8.LAUNCHES["int8_matmul"] == before + 1
    assert got.shape == (m, n) and got.dtype == torch.int32
    assert torch.equal(got.cpu(), int8.int8_matmul_plain(a, b))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_a_cuda_program_round_trips_through_the_artifact(cuda, tmp_path,
                                                         kind):
    """A small W artifact with its cuda programs (export_state(platforms=
    ("cuda",)), save_artifact), loaded with programs.load_programs on the
    card: equal to the eager ServingModel's call bit for bit at batches
    1, 2 and 5 with the same launches; cuDNN's TF32 on when called (the
    loader turns it off for fp32), and still on after."""
    import dataclasses

    import numpy as np

    from lctvqa_torch import export, programs
    from lctvqa_torch.config import small_test_config
    from lctvqa_torch.models import vqa_w

    mcfg = dataclasses.replace(
        small_test_config().model, arch_type="fixed", img_size=32,
        compute_dtype="float32" if kind == "float32" else "bfloat16",
        pallas_seq_lstm=True)
    params = vqa_w.init_w_model(torch.Generator().manual_seed(1), mcfg)
    path = str(tmp_path / "w.lctx")
    export.save_artifact(export.export_state(
        {"w_params": params}, mcfg, int8=kind == "int8",
        platforms=("cuda",), max_batch=8), path)
    loaded = programs.load_programs(path, "cuda")
    eager = export.load_artifact(path, "cuda", **{
        f: getattr(mcfg, f) for f in export.SERVING_FIELDS})
    torch.backends.cudnn.allow_tf32 = True
    rng = np.random.default_rng(2)
    for b in (1, 2, 5):
        u8 = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
        qst = rng.integers(0, mcfg.qst_vocab_size, (b, mcfg.max_qst_len),
                           dtype=np.int32)
        counts = []
        for model in (loaded, eager):
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            out = model.answer_logits(u8, qst)
            torch.cuda.synchronize()
            counts.append(_build.launch_counts())
            if model is loaded:
                got = out
        assert counts[0] == counts[1] and counts[0]["lstm_seq_final"] == 1
        assert got.dtype == out.dtype and torch.equal(got, out), b
    assert torch.backends.cudnn.allow_tf32 is True
