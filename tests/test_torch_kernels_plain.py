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
from test_torch_train import one_cpu_thread  # noqa: F401 (autouse)

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
                           "greedy_generate", "bn_fwd", "bn_bwd",
                           "mixed_node_fwd", "mixed_node_bwd",
                           "bn_fwd_sums", "bn_fwd_apply", "bn_bwd_sums",
                           "bn_bwd_apply", "mixed_node_fwd_sync_a",
                           "mixed_node_fwd_sync_b", "mixed_node_fwd_sync_z",
                           "mixed_node_bwd_sync_r", "mixed_node_bwd_sync_s",
                           "mixed_node_bwd_sync_x"}


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


# ---------------------------------------------------------------------------
# gradients: the plain versions of the backward kernels and the LSTM
# Functions against jax.grad through the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def _rel_close(got, want, tol, what=""):
    """|got - want| <= tol * max|want| (a gradient's own scale)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: err {err}, scale {scale}"


@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 8, 8, 16), (2, 16, 16, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_batchnorm_bwd_plain_matches_pallas_grad(shape, g_dtype):
    """dx of the BatchNorm Function on the CPU (batchnorm_bwd_plain on the
    saved x and stat) against jax.grad through batchnorm_pallas in
    interpret mode: within 1e-5 of the gradient's scale (summation order).
    With a bf16 output the cotangent arrives in bf16 in both."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[g_dtype]
    rng = np.random.default_rng(20)
    x = (rng.standard_normal(shape) * 1.7 + 0.4).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)

    def loss(v):
        y = PB.batchnorm_pallas(v, out_dtype=jdt, force_interpret=True)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g))

    want = jax.grad(loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = cuda_bn.BatchNormFn.apply(xt, tdt, cuda_bn.EPS)
    (y.float() * torch.from_numpy(g)).sum().backward()
    _rel_close(xt.grad.numpy(), want, 1e-5, "dx")
    # the same through the wrapper, and the plain formula on its own
    xr = torch.from_numpy(x).requires_grad_()
    (cuda_bn.batchnorm_fwd(xr, out_dtype=tdt).float()
     * torch.from_numpy(g)).sum().backward()
    assert torch.equal(xr.grad, xt.grad)
    stat = cuda_bn.batchnorm_stats_plain(torch.from_numpy(x))
    dx = cuda_bn.batchnorm_bwd_plain(torch.from_numpy(x),
                                     torch.from_numpy(g).to(tdt), stat)
    assert torch.equal(dx, xt.grad)


@pytest.mark.parametrize("dtype,edges", [("float32", 1), ("float32", 3),
                                         ("bfloat16", 2)])
def test_mixed_node_plain_grad_matches_pallas_grad(dtype, edges):
    """Autograd through mixed_node_plain against jax.grad through the
    Pallas node kernel (its backward kernel, in interpret mode), leaf by
    leaf: every edge state, every conv leaf of every edge, and weights.
    Inputs are floats from a seed, so the max pool has no ties. fp32
    within 1e-4 of each leaf's scale (summation order through two
    BatchNorm backward passes); bf16 within 2e-2: both treat a stage
    output's rounding as the identity, but a value that one rounds up
    and the other down after a 1-ulp fp32 difference moves a mask."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = 1e-4 if dtype == "float32" else 2e-2
    n, h, w, c, k = 4, 6, 5, 8, 4
    cs = c // k
    rng = np.random.default_rng(30 + edges)
    keys = jax.random.split(jax.random.PRNGKey(40 + edges), edges)
    ps = [jax.tree_util.tree_map(np.asarray,
                                 j_search.mixed_op_init(kk, c, 1, k))
          for kk in keys]
    xs = [rng.standard_normal((n, h, w, c)).astype(np.float32)
          for _ in range(edges)]
    wts = rng.uniform(0.02, 0.2, (edges, 8)).astype(np.float32)
    g = rng.standard_normal((n, h, w, cs)).astype(np.float32)

    def loss(xs_, ps_, wts_):
        hwcn = tuple(jnp.transpose(x[..., :cs].astype(jdt),
                                   (1, 2, 3, 0)).reshape(h, w, cs * n)
                     for x in xs_)
        out = PM.mixed_node_pallas_hwcn(hwcn, ps_, wts_, cs, n, True)
        out = jnp.transpose(out.reshape(h, w, cs, n), (3, 0, 1, 2))
        return jnp.sum(out * jnp.asarray(g))

    want_x, want_p, want_w = jax.grad(loss, argnums=(0, 1, 2))(
        [jnp.asarray(x) for x in xs], _jax(ps), jnp.asarray(wts))

    txs = [torch.from_numpy(x).requires_grad_() for x in xs]
    tps = [convert.from_jax(p) for p in ps]
    leaves = [t.requires_grad_() for p in tps
              for t in jax.tree_util.tree_leaves(p)]
    twts = torch.from_numpy(wts).requires_grad_()
    out = cuda_mixedop.mixed_node([x.to(tdt) for x in txs], tps, twts, cs)
    (out * torch.from_numpy(g)).sum().backward()
    for e in range(edges):
        _rel_close(txs[e].grad.numpy(), want_x[e], tol, f"dx[{e}]")
        got_p = convert.to_jax(jax.tree_util.tree_map(lambda t: t.grad,
                                                      tps[e]))
        flat_got = jax.tree_util.tree_leaves_with_path(got_p)
        flat_want = jax.tree_util.tree_leaves(want_p[e])
        assert len(flat_got) == len(flat_want) == 12
        for (path, a), b in zip(flat_got, flat_want):
            _rel_close(a, b, tol, f"edge {e} {jax.tree_util.keystr(path)}")
    _rel_close(twts.grad.numpy(), want_w, tol, "d weights")
    assert len(leaves) == 12 * edges


def test_mixed_node_weights_get_a_gradient_at_zero():
    """d weights[e, op] does not vanish where the weight is exactly 0."""
    n, h, w, c, cs = 2, 5, 4, 8, 2
    rng = np.random.default_rng(33)
    p = convert.from_jax(jax.tree_util.tree_map(
        np.asarray, j_search.mixed_op_init(jax.random.PRNGKey(3), c, 1, 4)))
    x = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(np.float32))
    wts = torch.zeros(1, 8, requires_grad=True)
    out = cuda_mixedop.mixed_node([x], [p], wts, cs)
    (out * torch.from_numpy(rng.standard_normal(
        (n, h, w, cs)).astype(np.float32))).sum().backward()
    assert bool((wts.grad[0, 1:].abs() > 0).all()) and wts.grad[0, 0] == 0


LSTM_FNS = {
    "cell": (cuda_lstm.LstmCellFn,
             lambda lp, xs, h, c, dt: PL.lstm_cell_pallas(
                 lp, xs[:, 0], h, c, dtype=dt, force_interpret=True),
             lambda xs: xs[:, 0]),
    "seq_final": (cuda_lstm.LstmSeqFinalFn,
                  lambda lp, xs, h, c, dt: PL.lstm_seq_final_pallas(
                      lp, xs, h, c, dtype=dt, force_interpret=True),
                  lambda xs: xs),
    "seq_all": (cuda_lstm.LstmSeqFn,
                lambda lp, xs, h, c, dt: jax.tree_util.tree_leaves(
                    PL.lstm_seq_pallas(lp, xs, h, c, dtype=dt,
                                       force_interpret=True)),
                lambda xs: xs),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(LSTM_FNS))
def test_lstm_function_grads_match_jax(name, dtype):
    """The three LSTM Functions on the CPU (plain forward, autograd
    through the plain version backward) against jax.grad through the
    Pallas kernels in interpret mode, whose derivative is the jnp tangent
    rule: x, h0, c0 and the four weight leaves. fp32 within 1e-4 of each
    gradient's scale; bf16 operands within 3e-2 (the casts lie outside
    the primitive in both, and a rounded h differs now and then)."""
    jdt, tdt, _ = DTYPES[dtype]
    tol = 1e-4 if dtype == "float32" else 3e-2
    fn, jfn, pick = LSTM_FNS[name]
    rng = np.random.default_rng(50)
    lp = _layer(rng)
    xs = rng.standard_normal((B, T, E)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    c0 = (0.5 * rng.standard_normal((B, H))).astype(np.float32)
    n_out = {"cell": 2, "seq_final": 2, "seq_all": 3}[name]
    gs = [rng.standard_normal(s).astype(np.float32) for s in
          ([(B, T, H)] if n_out == 3 else []) + [(B, H), (B, H)]]

    def loss(lp_, xs_, h_, c_):
        outs = jfn(lp_, xs_, h_, c_, jdt)
        return sum(jnp.sum(o * jnp.asarray(g)) for o, g in zip(outs, gs))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        _jax(lp), jnp.asarray(xs), jnp.asarray(h0), jnp.asarray(c0))
    tlp = {k: v.requires_grad_() for k, v in _torch(lp).items()}
    txs, th, tc = (torch.from_numpy(a).requires_grad_()
                   for a in (xs, h0, c0))
    w = cuda_lstm.cell_weights(tlp, tdt)
    outs = fn.apply(pick(txs), th, tc, *w)
    sum((o * torch.from_numpy(g)).sum() for o, g in zip(outs, gs)).backward()
    _rel_close(txs.grad.numpy(), want[1], tol, "dx")
    _rel_close(th.grad.numpy(), want[2], tol, "dh0")
    _rel_close(tc.grad.numpy(), want[3], tol, "dc0")
    for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
        _rel_close(tlp[k].grad.numpy(), want[0][k], tol, k)


# ---------------------------------------------------------------------------
# the sequence kernel's launch shape and scratch (plain Python helpers)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hid,dtype,want", [
    # bf16: 8 units a block, 64-row batch tiles, whatever H is
    (512, torch.bfloat16, (8, 64, 64, 132608)),
    (1024, torch.bfloat16, (8, 128, 64, 230912)),
    (48, torch.bfloat16, (8, 6, 64, 58880)),
    # fp32: 4 units and a 64-row tile where H / 4 blocks fit on 132 SMs
    # and the tile in shared memory beside the weights, else 8 and 16
    (512, torch.float32, (4, 128, 64, 230400)),
    (528, torch.float32, (8, 66, 16, 143616)),
    (576, torch.float32, (8, 72, 16, 143616)),
    (1024, torch.float32, (8, 128, 16, 229632)),
], ids=lambda v: str(v).replace("torch.", ""))
def test_seq_plan_shapes(hid, dtype, want):
    plan = cuda_lstm.seq_plan(hid, dtype, 132)
    assert (plan["units"], plan["blocks"], plan["batch_tile"],
            plan["smem_bytes"]) == want
    assert plan["threads"] == 512
    # every unit has a block, no block is empty, one block per SM at most
    assert (plan["blocks"] - 1) * plan["units"] < hid \
        <= plan["blocks"] * plan["units"]
    assert plan["blocks"] <= 132
    assert plan["smem_bytes"] <= cuda_lstm.SMEM_PER_BLOCK
    # one thread per (row, unit) of a batch tile finishes the cell
    assert plan["batch_tile"] * plan["units"] <= plan["threads"]


def test_seq_plan_refuses_a_card_too_small():
    # H = 1024 needs 128 resident blocks
    with pytest.raises(ValueError, match="resident blocks"):
        cuda_lstm.seq_plan(1024, torch.bfloat16, 108)
    assert cuda_lstm.seq_plan(512, torch.bfloat16, 108)["blocks"] == 64
    # fp32 at H = 512 falls back to 8 units on 108 SMs
    assert cuda_lstm.seq_plan(512, torch.float32, 108)["units"] == 8


def test_seq_scratch_bytes():
    # the counter's 256 bytes, then [2, B, H rounded up to 8] of the dtype
    assert cuda_lstm.seq_scratch_bytes(64, 512, torch.bfloat16) \
        == 256 + 2 * 64 * 512 * 2
    assert cuda_lstm.seq_scratch_bytes(3, 50, torch.float32) \
        == 256 + 2 * 3 * 56 * 4
    # rows of the exchange buffer start on 16 bytes
    for hid in (1, 7, 48, 50, 1024):
        for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
            row = (cuda_lstm.seq_scratch_bytes(1, hid, dtype) - 256) // 2
            assert row % 16 == 0 and row >= hid * size



# ---------------------------------------------------------------------------
# the cell kernel's launch shape and wrapper, the node forward's scratch
# (plain Python; the launch itself is replaced by a recorder)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("emb,hid,dtype,want", [
    # bf16: 8 units a block, the largest batch tile of 64, 32, 16 rows
    (300, 512, torch.bfloat16, (64, 64, 203520)),
    (300, 1024, torch.bfloat16, (128, 32, 224512)),
    (20, 50, torch.bfloat16, (7, 64, 53760)),
    # fp32: 4 units a block, tiles of 32 or 16 rows
    (300, 512, torch.float32, (128, 32, 193024)),
    (7, 1024, torch.float32, (256, 16, 155904)),
    (9, 80, torch.float32, (20, 32, 57856)),
], ids=lambda v: str(v).replace("torch.", ""))
def test_cell_plan_shapes(emb, hid, dtype, want):
    plan = cuda_lstm.cell_plan(emb, hid, dtype)
    assert (plan["blocks"], plan["batch_tile"], plan["smem_bytes"]) == want
    units = 8 if dtype == torch.bfloat16 else 4
    assert plan["units"] == units and plan["threads"] == 512
    assert plan["smem_bytes"] <= cuda_lstm.SMEM_PER_BLOCK
    # every unit has a block; one thread per (row, unit) of a tile finishes
    assert (plan["blocks"] - 1) * units < hid <= plan["blocks"] * units
    assert plan["batch_tile"] * plan["units"] <= plan["threads"]


def test_cell_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="too large"):
        cuda_lstm.cell_plan(2000, 1024, torch.float32)
    # a smaller card's limit takes a smaller tile
    assert cuda_lstm.cell_plan(300, 512, torch.bfloat16,
                               smem_max=180000)["batch_tile"] == 32
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_lstm.cell_plan(300, 512, torch.float16)


@pytest.mark.parametrize("bsz", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("tile", [64, 32, 16])
def test_cell_batch_tiles(bsz, tile):
    tiles = cuda_lstm.cell_batch_tiles(bsz, tile)
    assert [b0 for b0, _ in tiles] == list(range(0, bsz, tile))
    assert sum(rows for _, rows in tiles) == bsz
    assert all(0 < rows <= tile for _, rows in tiles)
    assert all(rows == tile for _, rows in tiles[:-1])
    assert len(tiles) == -(-bsz // tile)


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, device, *args):
        self.calls.append(args)


def _cell_inputs(dtype, x_dtype=torch.float32, bsz=5, emb=12, hid=8):
    rng = np.random.default_rng(60)
    lp = {"w_ih": rng.standard_normal((emb, 4 * hid)),
          "w_hh": rng.standard_normal((hid, 4 * hid)),
          "b_ih": rng.standard_normal(4 * hid),
          "b_hh": rng.standard_normal(4 * hid)}
    w = cuda_lstm.cell_weights(
        {k: torch.tensor(v, dtype=torch.float32) for k, v in lp.items()},
        dtype)
    xs = torch.tensor(rng.standard_normal((bsz, 3, emb)), dtype=x_dtype)
    h = torch.tensor(rng.standard_normal((bsz, hid)), dtype=torch.float32)
    return w, xs, h


def test_cell_wrapper_one_output_and_no_needless_copy(monkeypatch):
    """The wrapper's host side without a card: one [2, B, H] fp32 output
    whose two views are h' and c'; x handed over in place, strided, in
    fp32 or the compute dtype; a copy only for what the kernel does not
    take."""
    rec = _Recorder()
    monkeypatch.setattr(cuda_lstm.CELL, "launch", rec)
    monkeypatch.setattr(cuda_lstm.K, "check_cuda_tensors", lambda *a, **k: 0)
    w, xs, h = _cell_inputs(torch.bfloat16)
    x = xs[:, 1]  # a strided view, as a caller slices a sequence
    h_out, c_out = cuda_lstm._cell_kernel(w, x, h, h)
    (args,) = rec.calls
    out = args[8]
    assert out.shape == (2, 5, 8) and out.dtype == torch.float32
    assert out.is_contiguous()
    assert h_out.data_ptr() == out.data_ptr()
    assert c_out.data_ptr() == out.data_ptr() + 5 * 8 * 4
    assert h_out.stride() == c_out.stride() == (8, 1)
    assert h_out.shape == c_out.shape == (5, 8)
    assert args[0] is x and args[1] == 3 * 12 and args[2] == 0  # fp32 x
    assert args[3] is h and args[4] is h
    assert args[5] is w.w_ih and args[6] is w.w_hh and args[7] is w.b
    assert args[9:] == (5, 12, 8, 1)  # B, E, H, bf16
    # x already in the compute dtype goes as it is, with its code
    _, xb, _ = _cell_inputs(torch.bfloat16, torch.bfloat16)
    cuda_lstm._cell_kernel(w, xb[:, 0], h, h)
    assert rec.calls[-1][0].dtype == torch.bfloat16
    assert rec.calls[-1][2] == 1
    # fp16 x and a transposed h are copied to what the kernel takes
    cuda_lstm._cell_kernel(w, xs[:, 0].half(), h.t().contiguous().t(), h)
    args = rec.calls[-1]
    assert args[0].dtype == torch.float32 and args[0].is_contiguous()
    assert args[2] == 0 and args[3].is_contiguous()
    with pytest.raises(ValueError, match="w_ih"):
        cuda_lstm._cell_kernel(w, torch.zeros(5, 13), h, h)


def test_cell_weights_are_checked_once_where_they_are_cast():
    w, _, _ = _cell_inputs(None)
    with pytest.raises(ValueError, match="b must be"):
        cuda_lstm.check_cell_weights(cuda_lstm.CellWeights(
            w.w_ih, w.w_hh, w.b.double()))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_lstm.check_cell_weights(cuda_lstm.CellWeights(
            w.w_ih.t().contiguous().t(), w.w_hh, w.b))
    with pytest.raises(ValueError, match="w_hh"):
        cuda_lstm.cell_weights({"w_ih": torch.zeros(3, 32),
                                "w_hh": torch.zeros(8, 31),
                                "b_ih": torch.zeros(32),
                                "b_hh": torch.zeros(32)}, None)


@pytest.mark.parametrize("e,n,h,w,cs,dtype,blocks,want", [
    # cell 0 of the supernet at batch 64: 84 MB of stage outputs, 32 x 32
    # tiles
    (5, 64, 64, 64, 4, torch.bfloat16, 256,
     (0, 83886080, 84213808, 84215088)),
    (3, 64, 16, 16, 16, torch.bfloat16, 64,
     (0, 12582912, 12779552, 12782624)),
    # an odd shape in fp32: 8 x 8 tiles past 16 channels (16 x 16 between)
    (2, 3, 7, 9, 24, torch.float32, 6, (0, 290304, 308752, 311824)),
], ids=["cell0", "cell2", "odd"])
def test_node_scratch_layout(e, n, h, w, cs, dtype, blocks, want):
    lay = cuda_mixedop.node_scratch(e, n, h, w, cs, dtype)
    assert lay["blocks"] == blocks
    assert (lay["obuf"], lay["partial"], lay["stat"], lay["total"]) == want
    size = 2 if dtype == torch.bfloat16 else 4
    tile = cuda_mixedop.node_tile(cs)
    assert blocks == n * -(-h // tile) * -(-w // tile)
    assert lay["partial"] >= 8 * e * cs * n * h * w * size
    # the partial sums, then two counters per edge, before the statistics
    assert lay["stat"] - lay["partial"] >= 8 * e * cs * 2 * blocks * 4 + 8 * e
    assert lay["total"] - lay["stat"] == 8 * e * cs * 2 * 4
    assert all(lay[k] % 16 == 0 for k in ("partial", "stat"))


def test_node_forward_wrapper_hands_over_one_scratch(monkeypatch):
    """node_fwd_launch without a card: one scratch tensor, the edge
    arguments packed as mixedop.cu's NodeArgs, and obuf / stat handed
    back as the backward reads them (views of the scratch)."""
    import ctypes

    rec, packed = _Recorder(), []

    def launch(device, *args):  # NodeArgs lives only for the call
        packed.extend((ctypes.c_longlong * 48).from_address(args[0]))
        rec(device, *args)

    monkeypatch.setattr(cuda_mixedop.MIXED_NODE, "launch", launch)
    n, h, w, c, cs = 2, 5, 6, 16, 4
    wide = torch.zeros(n, h, w, c, dtype=torch.bfloat16)
    xs = [wide[..., :cs], wide[..., 4:4 + cs]]
    nodes = [cuda_mixedop.NodeWeights(torch.zeros(8, 25, cs),
                                      torch.zeros(8, cs, cs))
             for _ in xs]
    wts = torch.zeros(2, 8)
    out, obuf, stat = cuda_mixedop.node_fwd_launch(xs, nodes, wts, cs, "cpu")
    (args,) = rec.calls
    lay = cuda_mixedop.node_scratch(2, n, h, w, cs, torch.bfloat16)
    base = obuf.data_ptr()
    assert args[2:5] == (base, base + lay["partial"], base + lay["stat"])
    assert args[5] is out and args[6:] == (2, n, h, w, cs, 1)
    assert out.shape == (n, h, w, cs) and out.dtype == torch.float32
    assert obuf.shape == (8, 2, cs, n * h * w)
    assert obuf.dtype == torch.bfloat16 and obuf.is_contiguous()
    assert stat.shape == (8, 2, cs, 2) and stat.dtype == torch.float32
    assert stat.data_ptr() == base + lay["stat"]
    assert obuf.untyped_storage().nbytes() == lay["total"]
    # NodeArgs: eight edges of (x, sn, sh, sw, dw, pw), the rest zero
    assert list(packed[:6]) == [xs[0].data_ptr(), h * w * c, w * c, c,
                                nodes[0].dw.data_ptr(),
                                nodes[0].pw.data_ptr()]
    assert packed[6] == xs[1].data_ptr() == xs[0].data_ptr() + 8
    assert list(packed[12:]) == [0] * 36


# ---------------------------------------------------------------------------
# the decode kernel's launch shape and scratch, the node backward's one
# tensor and wrapper (plain Python; the launch is replaced by a recorder)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("emb,hid,vpad,dtype,sms,want", [
    # full width on 132 SMs: 64 gate blocks of 8 units, 64 head blocks of
    # 128 columns; bf16 64-row tiles, fp32 16-row gate tiles
    (300, 512, 8192, torch.bfloat16, 132, (64, 64, 64, 128, 64, 206336)),
    (300, 512, 8192, torch.float32, 132, (64, 16, 64, 128, 64, 192768)),
    # 114 SMs: 168 columns a head block, whose slice leaves room for a
    # 16-row tile only
    (300, 512, 8192, torch.bfloat16, 114, (64, 64, 49, 168, 16, 217600)),
    # small widths
    (24, 48, 136, torch.bfloat16, 132, (6, 64, 17, 8, 64, 58880)),
    (24, 48, 136, torch.float32, 132, (6, 16, 17, 8, 64, 57600)),
    (20, 80, 1000, torch.float32, 132, (10, 16, 63, 16, 64, 57600)),
], ids=lambda v: str(v).replace("torch.", ""))
def test_generate_plan_shapes(emb, hid, vpad, dtype, sms, want):
    plan = cuda_generate.generate_plan(emb, hid, vpad, dtype, sms)
    assert (plan["gate_blocks"], plan["gate_tile"], plan["head_blocks"],
            plan["head_cols"], plan["head_tile"], plan["smem_bytes"]) == want
    assert plan["threads"] == 512 and plan["units"] == 8
    assert plan["blocks"] == plan["gate_blocks"] + plan["head_blocks"] <= sms
    # every unit and every column has a block, no block is empty
    assert (plan["gate_blocks"] - 1) * 8 < hid <= plan["gate_blocks"] * 8
    cols = plan["head_cols"]
    assert cols % 8 == 0
    assert (plan["head_blocks"] - 1) * cols < vpad <= plan["head_blocks"] * cols
    assert plan["smem_bytes"] <= cuda_lstm.SMEM_PER_BLOCK


def test_generate_plan_refuses_a_card_too_small():
    # H = 1024 leaves 4 SMs for a head of 8192 columns in shared memory
    with pytest.raises(ValueError, match="too large"):
        cuda_generate.generate_plan(300, 1024, 8192, torch.bfloat16, 132)
    # no SM left for the head at all
    with pytest.raises(ValueError, match="resident blocks"):
        cuda_generate.generate_plan(300, 512, 8192, torch.bfloat16, 64)
    # a smaller shared-memory limit takes smaller batch tiles
    plan = cuda_generate.generate_plan(300, 512, 8192, torch.bfloat16, 132,
                                       smem_max=200000)
    assert (plan["gate_tile"], plan["head_tile"]) == (32, 32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_generate.generate_plan(300, 512, 8192, torch.float16, 132)


def test_generate_scratch_bytes():
    # two counters in 256 bytes, 64-bit keys [T, B], the h exchange [2, B,
    # HX] and the head's input [B, HX] of the dtype, c [B, H] fp32
    assert cuda_generate.generate_scratch_bytes(64, 30, 512, torch.bfloat16) \
        == 256 + 8 * 64 * 30 + 3 * 64 * 512 * 2 + 4 * 64 * 512
    assert cuda_generate.generate_scratch_bytes(3, 7, 50, torch.float32) \
        == 256 + 176 + 3 * 3 * 56 * 4 + 608
    for bsz, steps, hid in ((1, 1, 1), (5, 3, 7), (65, 30, 50)):
        for dtype in (torch.bfloat16, torch.float32):
            assert cuda_generate.generate_scratch_bytes(
                bsz, steps, hid, dtype) % 16 == 0


def test_generate_wrapper_hands_over_zeroed_scratch(monkeypatch):
    """The decode's host side without a card: one launch with the tokens
    [B, T] int32 and one zeroed scratch of generate_scratch_bytes; a grid
    the card cannot hold raises before anything launches."""
    rec = _Recorder()
    monkeypatch.setattr(cuda_generate.GENERATE, "launch", rec)
    monkeypatch.setattr(cuda_generate.K, "check_cuda_tensors",
                        lambda *a, **k: torch.device("cpu"))
    monkeypatch.setattr(cuda_generate, "_sm_count", lambda index: 132)
    rng = np.random.default_rng(61)
    emb, hid, vocab, bsz, steps = 12, 8, 21, 3, 5

    def qst_params(hid):
        def t(*shape):
            return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
        return {"word2vec": {"table": t(vocab, emb)},
                "lstm": {"layers": [{"w_ih": t(emb, 4 * hid),
                                     "w_hh": t(hid, 4 * hid),
                                     "b_ih": t(4 * hid), "b_hh": t(4 * hid)}]},
                "fc2": {"w": t(hid, vocab), "b": t(vocab)}}

    d = cuda_generate.decode_weights(qst_params(hid), torch.bfloat16)
    assert d.fc2_w.shape == (hid, 24) and d.fc2_b.shape == (24,)
    assert bool(torch.isinf(d.fc2_b[vocab:]).all())
    tokens = cuda_generate._generate_kernel(d, torch.zeros(bsz, hid), steps)
    (args,) = rec.calls
    assert args[8] is tokens and tokens.shape == (bsz, steps)
    assert tokens.dtype == torch.int32
    scratch = args[9]
    assert scratch.dtype == torch.uint8 and not bool(scratch.any())
    assert scratch.numel() == cuda_generate.generate_scratch_bytes(
        bsz, steps, hid, torch.bfloat16)
    assert args[10:] == (bsz, steps, emb, hid, 24, 1)
    # 1,056 hidden units need 132 gate blocks: no SM is left for the head
    big = cuda_generate.decode_weights(qst_params(1056), torch.bfloat16)
    with pytest.raises(ValueError, match="resident blocks"):
        cuda_generate._generate_kernel(big, torch.zeros(bsz, 1056), steps)
    assert len(rec.calls) == 1


@pytest.mark.parametrize("e,n,h,w,cs,dtype,want", [
    # cell 0 at batch 64: 32 x 32 tiles, 256 blocks and 1024-pixel chunks an
    # edge; dz is 42 MB of the 57 MB
    (5, 64, 64, 64, 4, torch.bfloat16,
     (256, 256, 10485760, 10504480, 10649360, 52674640, 57431184)),
    (3, 64, 16, 16, 16, torch.bfloat16,
     (64, 16, 1572864, 1635936, 1661088, 8002464, 12033744)),
    # an odd shape in fp32: 8 x 8 tiles past 16 channels
    (2, 3, 7, 9, 24, torch.float32,
     (6, 1, 36288, 111616, 116608, 194560, 646224)),
], ids=["cell0", "cell2", "odd"])
def test_node_bwd_scratch_layout(e, n, h, w, cs, dtype, want):
    lay = cuda_mixedop.node_bwd_scratch(e, n, h, w, cs, dtype)
    assert (lay["blocks"], lay["chunks"], lay["ddw"], lay["scratch"],
            lay["dzp"], lay["part_dw"], lay["total"]) == want
    tile = cuda_mixedop.node_tile(cs)
    blocks = n * -(-h // tile) * -(-w // tile)
    m = n * h * w
    chunks = -(-m // 1024)
    assert lay["blocks"] == blocks and lay["chunks"] == chunks
    size = 2 if dtype == torch.bfloat16 else 4
    # the outputs first, then the fp32 scratch as mixedop.cu's bwd_scratch
    # lays it out: parts in this order, each rounded up to 16 bytes
    parts = [("dx", e * m * cs * size), ("ddw", e * 8 * 25 * cs * 4),
             ("dpw", e * 8 * cs * cs * 4), ("dweights", e * 8 * 4),
             ("part_r", e * cs * 7 * chunks * 4), ("fc", 6 * e * cs * 3 * 4),
             ("gbar", e * cs * 4), ("dzp", 2 * e * cs * m * 4),
             ("part_s", 2 * e * cs * 2 * blocks * 4),
             ("mstat", 2 * e * cs * 2 * 4),
             ("part_dw", e * 8 * 25 * cs * blocks * 4),
             ("part_pw", e * 8 * cs * cs * blocks * 4),
             ("part_skip", e * blocks * 4), ("counters", 3 * e * 4)]
    at = 0
    for key, nbytes in parts:
        assert lay[key] == at and at % 16 == 0, key
        at += -(-nbytes // 16) * 16
    assert lay["total"] == at
    assert lay["scratch"] == lay["part_r"]


def test_node_backward_wrapper_hands_over_one_tensor(monkeypatch):
    """node_bwd_launch without a card: one launch whose outputs and
    scratch are parts of one tensor at node_bwd_scratch's offsets; the
    returned dx, d dw, d pw and d weights [E, 8] are views of it as the
    kernel writes them, nothing assembled after the launch."""
    import ctypes

    rec, packed = _Recorder(), []

    def launch(device, *args):  # NodeArgs lives only for the call
        packed.extend((ctypes.c_longlong * 48).from_address(args[0]))
        rec(device, *args)

    monkeypatch.setattr(cuda_mixedop.MIXED_NODE_BWD, "launch", launch)
    n, h, w, c, cs = 2, 5, 6, 16, 4
    wide = torch.zeros(n, h, w, c, dtype=torch.bfloat16)
    xs = [wide[..., :cs], wide[..., 8:8 + cs]]
    nodes = [cuda_mixedop.NodeWeights(torch.zeros(8, 25, cs),
                                      torch.zeros(8, cs, cs)) for _ in xs]
    wts, g = torch.zeros(2, 8), torch.zeros(n, h, w, cs)
    obuf, stat = torch.zeros(8, 2, cs, n * h * w), torch.zeros(8, 2, cs, 2)
    dxs, ddw, dpw, dwt = cuda_mixedop.node_bwd_launch(
        xs, nodes, wts, g, obuf, stat, cs, "cpu")
    (args,) = rec.calls
    lay = cuda_mixedop.node_bwd_scratch(2, n, h, w, cs, torch.bfloat16)
    base = dxs[0].data_ptr() - lay["dx"]
    assert args[1] == base + lay["dx"]
    assert args[2] is wts and args[3] is g and args[4] is obuf
    assert args[5] is stat
    assert args[6:10] == (base + lay["scratch"], base + lay["ddw"],
                          base + lay["dpw"], base + lay["dweights"])
    assert args[10:] == (2, n, h, w, cs, 1)
    assert [d.shape for d in dxs] == [(n, h, w, cs)] * 2
    assert all(d.dtype == torch.bfloat16 for d in dxs)
    assert dxs[1].data_ptr() == base + n * h * w * cs * 2
    assert ddw.shape == (2, 8, 25, cs) and ddw.data_ptr() == args[7]
    assert dpw.shape == (2, 8, cs, cs) and dpw.data_ptr() == args[8]
    assert dwt.shape == (2, 8) and dwt.dtype == torch.float32
    assert dwt.data_ptr() == args[9] and dwt.is_contiguous()
    assert dxs[0].untyped_storage().nbytes() == lay["total"]
    # NodeArgs: eight edges of (x, sn, sh, sw, dw, pw), the rest zero
    assert list(packed[:6]) == [xs[0].data_ptr(), h * w * c, w * c, c,
                                nodes[0].dw.data_ptr(),
                                nodes[0].pw.data_ptr()]
    assert list(packed[12:]) == [0] * 36


# ---------------------------------------------------------------------------
# the BatchNorm kernels' launch plan and scratch (plain Python; the launch
# is replaced by a recorder), the node backward's decision-matched plain
# version
# ---------------------------------------------------------------------------

BN_PLAN_SHAPES = [(64, 64, 64, 16), (64, 64, 64, 32), (64, 32, 32, 64),
                  (64, 16, 16, 64), (64, 32, 32, 8), (64, 16, 16, 16),
                  (1, 1, 1, 3), (3, 37, 41, 12), (3, 49, 71, 4),
                  (2, 3, 5, 1028), (1, 1, 1, 8)]
F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("sms,smem", [(132, 232448), (114, 232448),
                                      (16, 101376)])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_bn_plan_fits_the_card_and_covers_every_row(backward, sms, smem):
    """bn_plan at every shape and dtype pair: at most one block an SM (what
    a cooperative launch of one block an SM can hold), 256 threads a block
    where every row is staged and 512 where not, shares
    that cover the M rows with none empty and start on 16 bytes where the
    kernel copies 16 bytes at a time, staged rows and the reductions within
    shared memory."""
    for shape in BN_PLAN_SHAPES:
        c = shape[-1]
        m = int(np.prod(shape[:-1]))
        for xd in (F32, BF16):
            for od in (F32, BF16):
                p = cuda_bn.bn_plan(m, c, xd, od, backward, sms, smem)
                ex = 4 if xd == F32 else 2
                eg = (4 if od == F32 else 2) if backward else 0
                assert p["threads"] == (256 if p["staged"] == p["rows"]
                                        else 512)
                assert 1 <= p["blocks"] <= sms
                assert (p["blocks"] - 1) * p["rows"] < m <= (
                    p["blocks"] * p["rows"])
                assert 0 <= p["staged"] <= p["rows"]
                assert p["smem_bytes"] <= smem
                assert p["smem_bytes"] >= p["staged"] * c * (ex + eg)
                assert p["vec"] == (4 if c % 4 == 0 else 1)
                assert p["lanes"] in (1, 2, 4, 8, 16, 32)
                assert p["lanes"] * p["vec"] >= min(c, 32 * p["vec"])
                if p["vec"] == 4:
                    assert p["rows"] * c * ex % 16 == 0
                    assert p["rows"] * c * eg % 16 == 0
                # a 1 MB tensor does not take every SM
                if m * c * (ex + eg) <= 2 ** 20:
                    assert p["blocks"] <= 64


@pytest.mark.parametrize("m,c,xd,od,backward,want", [
    # [64,64,64,32] fp32 -> bf16: 132 blocks of 512 threads, 1781 of 1986
    # rows on chip
    (262144, 32, F32, BF16, False, (132, 512, 1986, 1781, 232352)),
    # its backward with g bf16: 1186 rows of x and g on chip
    (262144, 32, F32, BF16, True, (132, 512, 1986, 1186, 232352)),
    # bf16 in: all of it on chip, 256 threads a block
    (262144, 32, BF16, BF16, False, (132, 256, 1986, 1986, 129440)),
    # the stride-2 edges' inner BatchNorm: fewer blocks, all on chip
    (65536, 8, F32, BF16, False, (128, 256, 512, 512, 17504)),
    (16384, 16, BF16, BF16, False, (32, 256, 512, 512, 17568)),
    (16384, 16, F32, BF16, True, (96, 256, 171, 171, 17728)),
    # C = 3: one channel a lane, any row start
    (1, 3, F32, F32, False, (1, 256, 1, 1, 1104)),
])
def test_bn_plan_values(m, c, xd, od, backward, want):
    """bn_plan on a 132-SM card with 227 KB of shared memory a block:
    blocks, threads, rows a block, rows staged, shared memory (the card
    tests hold bn_plan equal to the C side's own choice)."""
    p = cuda_bn.bn_plan(m, c, xd, od, backward)
    assert (p["blocks"], p["threads"], p["rows"], p["staged"],
            p["smem_bytes"]) == want


def test_bn_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="too large"):
        cuda_bn.bn_plan(4, 60000, F32, F32, True)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_bn_wrappers_hand_over_one_scratch(monkeypatch, backward):
    """batchnorm_fwd_stat / batchnorm_bwd without a card: one launch with
    the plan's block count and one fp32 allocation [rows, C] that holds the
    forward's stat [2, C], then the barrier's counter (the scratch pointer
    handed over) and blocks x 2C partials."""
    rec = _Recorder()
    kernel = cuda_bn.BN_BWD if backward else cuda_bn.BN_FWD
    monkeypatch.setattr(kernel, "launch", rec)
    monkeypatch.setattr(cuda_bn, "_card", lambda index: (132, 232448))
    shape, c = (64, 16, 16, 16), 16
    x = torch.empty(shape, device="meta")
    plan = cuda_bn.bn_plan(16384, c, F32, BF16, backward)
    lay = cuda_bn.bn_scratch(plan, c)
    assert lay["counter"] == 2 * c * 4 and lay["partial"] == lay["counter"] + 16
    assert lay["total"] == lay["partial"] + plan["blocks"] * 2 * c * 4
    assert lay["rows"] * c * 4 >= lay["total"] > (lay["rows"] - 1) * c * 4
    with pytest.raises(ValueError, match="CUDA"):  # meta is not the card
        (cuda_bn.batchnorm_bwd(x, x, x[0, 0, :2]) if backward
         else cuda_bn.batchnorm_fwd_stat(x))
    monkeypatch.setattr(cuda_bn.K, "check_cuda_tensors",
                        lambda *a, **k: torch.device("meta"))
    allocs = []
    real_empty = torch.empty

    def empty(*args, **kwargs):
        allocs.append(real_empty(*args, **kwargs))
        return allocs[-1]

    monkeypatch.setattr(cuda_bn.torch, "empty", empty)
    if backward:
        g = real_empty(shape, device="meta", dtype=BF16)
        stat = real_empty(2, c, device="meta")
        dx = cuda_bn.batchnorm_bwd(x, g, stat)
        (args,) = rec.calls
        assert args[:4] == (x, g, stat, dx) and dx.dtype == F32
        assert args[5:] == (plan["blocks"], 16384, c, 0, 1)
        scratch = args[4]
    else:
        y, stat, x_read = cuda_bn.batchnorm_fwd_stat(x, BF16)
        (args,) = rec.calls
        assert args[:3] == (x, y, stat) and x_read is x
        assert y.dtype == BF16 and y.shape == shape
        assert stat.shape == (2, c) and stat.is_contiguous()
        assert stat.storage_offset() == 0
        assert args[4:] == (plan["blocks"], 16384, c, cuda_bn.EPS, 0, 1)
        scratch = args[3]
    buf = allocs[0]
    assert buf.shape == (lay["rows"], c) and buf.dtype == F32
    assert scratch == buf.data_ptr() + lay["counter"]
    if not backward:
        assert stat.untyped_storage().data_ptr() == buf.data_ptr()


def _kept_from_plain(xs, nodes, cs):
    """obuf / stat as the forward kernel leaves them for slots 0 and 1 (the
    sep convs' first stages), made from the plain version's values."""
    n, h, w, _ = xs[0].shape
    e_count, m = len(xs), n * h * w
    obuf = torch.zeros(8, e_count, cs, m)
    stat = torch.zeros(8, e_count, cs, 2)
    for e, (x, nw) in enumerate(zip(xs, nodes)):
        x = torch.relu(x[..., :cs].float())
        for b, (_, kk, dil, _) in enumerate(cuda_mixedop.BRANCHES[:2]):
            o = cuda_mixedop._stage(x, nw, 2 * b, kk, dil, torch.float32)
            mean, rstd = cuda_mixedop._stats(o)
            obuf[b, e] = o.permute(3, 0, 1, 2).reshape(cs, m)
            stat[b, e, :, 0], stat[b, e, :, 1] = mean, rstd
    return obuf, stat


def test_node_bwd_plain_takes_the_kept_relu_decisions():
    """mixed_node_bwd_plain(kept=...) reads the inner ReLU decisions from
    the kernel's stored stage outputs: where they equal its own it gives
    autograd's gradients (up to the order of autograd's sums), and one
    decision taken the other way moves dx only around that pixel."""
    gen = torch.Generator().manual_seed(71)
    n, h, w, c, cs, edges = 2, 9, 8, 16, 4, 3
    ops = [t_search.mixed_op_init(gen, c, 1, 4) for _ in range(edges)]
    nodes = [cuda_mixedop.node_weights(p) for p in ops]
    xs = [torch.randn(n, h, w, c, generator=gen)[..., :cs]
          for _ in range(edges)]
    wts = torch.softmax(torch.randn(edges, 8, generator=gen), 1)
    g = torch.randn(n, h, w, cs, generator=gen)
    obuf, stat = _kept_from_plain(xs, nodes, cs)
    kept = cuda_mixedop.sep_inner_inputs_kept(obuf, stat, (n, h, w))
    plain = cuda_mixedop.sep_inner_inputs_plain(xs, nodes, cs)
    for e in range(edges):
        for b in range(2):
            assert torch.equal(kept[e][b], plain[e][b])
    auto = cuda_mixedop.mixed_node_bwd_plain(xs, nodes, wts, g, cs)
    same = cuda_mixedop.mixed_node_bwd_plain(xs, nodes, wts, g, cs,
                                             kept=(obuf, stat))
    for a, b in zip(auto[0] + list(auto[1:]), same[0] + list(same[1:])):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    # edge 1's sep3 inner input at a positive pixel, stored just below 0
    e, q = 1, (1, 4, 3, 2)
    assert float(kept[e][0][q]) > 0
    pix = (q[0] * h + q[1]) * w + q[2]
    obuf[0, e, q[3], pix] = stat[0, e, q[3], 0] - 1e-6
    flip = cuda_mixedop.mixed_node_bwd_plain(xs, nodes, wts, g, cs,
                                             kept=(obuf, stat))
    diff = (flip[0][e] - auto[0][e]).abs()
    at = divmod(int(diff.flatten().argmax()), w * cs)
    worst = (at[0] // h, at[0] % h, at[1] // cs)
    assert worst[0] == q[0] and abs(worst[1] - q[1]) <= 1
    assert abs(worst[2] - q[2]) <= 1
    for other in (0, 2):
        assert torch.equal(flip[0][other], same[0][other])
