"""The port's kernels (lctvqa_torch/ops/cuda_lstm.py, cuda_generate.py,
cuda_bn.py, cuda_mixedop.py) against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
Pallas kernels run in interpret mode, as tests/test_pallas.py,
tests/test_pallas_generate.py and tests/test_pallas_mixedop.py run them.
Inputs come from a seeded numpy generator and go to both. Tolerances:
fp32 h/c within 1e-5 (summation order); bf16 operands within 2e-2 (bf16
rounds h at each step, and the two frameworks may round a value that
lies on a bf16 tie differently after a 1-ulp fp32 difference); greedy
tokens exact; BatchNorm and the mixed-op node as stated at their tests.
The CUDA kernels themselves are checked on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dataclasses

from lctvqa.config import small_test_config
from lctvqa.models import search as j_search
from lctvqa.ops import pallas_bn as PB
from lctvqa.ops import pallas_generate as PG
from lctvqa.ops import pallas_lstm as PL
from lctvqa.ops import pallas_mixedop as PM
from lctvqa_torch import convert
from lctvqa_torch.models import search as t_search
from lctvqa_torch.ops import (_build, conv as t_conv, cuda_bn, cuda_generate,
                              cuda_lstm, cuda_mixedop)

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
                           "greedy_generate", "bn_fwd", "mixed_node_fwd"}


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


# ---------------------------------------------------------------------------
# BatchNorm and the mixed-op node
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (2, 16, 16, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_batchnorm_plain_matches_pallas(shape, out_dtype):
    """fp32 out within 1e-5 (summation order); bf16 out within one bf16
    ulp of the normalized value (at most 2^-7 of it: a 1-ulp fp32
    difference may round the other way)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[out_dtype]
    x = (np.random.default_rng(7).standard_normal(shape) * 1.7 + 0.4).astype(
        np.float32)
    want = PB.batchnorm_pallas(jnp.asarray(x), out_dtype=jdt,
                               force_interpret=True)
    assert want.dtype == jdt
    got = cuda_bn.batchnorm_fwd(torch.from_numpy(x), out_dtype=tdt)
    assert got.dtype == tdt and got.shape == shape
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=1e-5,
        rtol=1e-5 if out_dtype == "float32" else 2.0 ** -7)
    # the routed op takes the same path for an affine-free BN
    assert torch.equal(t_conv.batchnorm({}, torch.from_numpy(x),
                                        out_dtype=tdt), got)


NODE_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
               # the two share every rounding point, so bf16 differs by
               # summation order only, far inside the JAX test's 5% of scale
               "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-3)}


@pytest.mark.parametrize("dtype", sorted(NODE_DTYPES))
@pytest.mark.parametrize("edges", [1, 3])
def test_mixed_node_plain_matches_pallas(edges, dtype):
    """A rectangular H x W, Cs = 2 of C = 8 channels, N = 4."""
    jdt, tdt, tol = NODE_DTYPES[dtype]
    n, h, w, c, k = 4, 6, 5, 8, 4
    cs = c // k
    rng = np.random.default_rng(8 + edges)
    keys = jax.random.split(jax.random.PRNGKey(edges), edges)
    ps = [jax.tree_util.tree_map(np.asarray,
                                 j_search.mixed_op_init(kk, c, 1, k))
          for kk in keys]
    xs = [rng.standard_normal((n, h, w, c)).astype(np.float32)
          for _ in range(edges)]
    wts = rng.uniform(0.02, 0.2, (edges, 8)).astype(np.float32)
    hwcn = tuple(jnp.transpose(jnp.asarray(x[..., :cs]).astype(jdt),
                               (1, 2, 3, 0)).reshape(h, w, cs * n)
                 for x in xs)
    want = PM.mixed_node_pallas_hwcn(hwcn, ps, jnp.asarray(wts), cs, n, True)
    want = np.transpose(np.asarray(want).reshape(h, w, cs, n), (3, 0, 1, 2))
    before = _build.launch_counts()
    got = cuda_mixedop.mixed_node(
        [torch.from_numpy(x).to(tdt) for x in xs],
        [convert.from_jax(p) for p in ps], torch.from_numpy(wts), cs)
    assert got.dtype == torch.float32 and got.shape == (n, h, w, cs)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * scale)
    assert _build.launch_counts() == before


def test_mixed_node_plain_special_ops():
    """'none' contributes exactly 0, stride-1 skip_connect is raw x with no
    BN, and the packed weights a served model holds under "node" are
    used as they are."""
    n, h, w, c, cs = 2, 5, 4, 8, 2
    rng = np.random.default_rng(9)
    p = convert.from_jax(jax.tree_util.tree_map(
        np.asarray, j_search.mixed_op_init(jax.random.PRNGKey(0), c, 1, 4)))
    x = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(np.float32))
    only = lambda i: torch.eye(8)[i][None] * 0.7  # noqa: E731
    assert torch.equal(cuda_mixedop.mixed_node([x], [p], only(0), cs),
                       torch.zeros(n, h, w, cs))
    skip = cuda_mixedop.mixed_node([x], [p], only(3), cs)
    torch.testing.assert_close(skip, 0.7 * x[..., :cs], rtol=0, atol=1e-6)
    packed = dict(p, node=cuda_mixedop.node_weights(p))
    assert cuda_mixedop.node_weights(packed) is packed["node"]
    wts = torch.from_numpy(rng.uniform(0.02, 0.2, (1, 8)).astype(np.float32))
    assert torch.equal(cuda_mixedop.mixed_node([x], [packed], wts, cs),
                       cuda_mixedop.mixed_node([x], [p], wts, cs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_network_with_node_kernel_matches_default_path(dtype):
    """The port's supernet with `pallas_mixed_op` on (plain versions on the
    CPU) against its own default path. fp32 within 1e-4. In bf16 the
    default path rounds between depthwise and pointwise and the node
    version does not, so the pooled features differ by bf16 rounding
    noise: within 2% of their scale (0.9% here; the JAX test allows the
    same pair of paths 5%)."""
    mcfg = dataclasses.replace(MCFG, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    params = t_search.network_init(gen, mcfg)
    arch = {k: torch.randn(v.shape, generator=gen)
            for k, v in t_search.arch_init(gen, mcfg).items()}
    x = torch.randn(4, mcfg.img_size, mcfg.img_size, 3, generator=gen)
    tdt = getattr(torch, dtype) if dtype != "float32" else None
    want = t_search.network_apply(params, arch, mcfg, x, dtype=tdt)
    got = t_search.network_apply(
        params, arch, dataclasses.replace(mcfg, pallas_mixed_op=True), x,
        dtype=tdt)
    tol = 1e-4 if dtype == "float32" else 2e-2 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert not torch.equal(got, want)  # another order of sums: not one path


def test_new_wrappers_refuse_tensors_off_cpu_and_cuda():
    x = torch.empty(2, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bn.batchnorm_fwd(x)
    nw = cuda_mixedop.NodeWeights(torch.empty(8, 25, 2, device="meta"),
                                  torch.empty(8, 2, 2, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mixedop.mixed_node([x], [{"node": nw}],
                                torch.empty(1, 8, device="meta"), 2)
