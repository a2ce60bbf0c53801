"""int8 serving (lctvqa_torch/quant.py, ops/int8.py and the int8 routes of
ops/conv.py::conv2d and ops/nn.py::linear) against the JAX package's
lctvqa/quant.py on the CPU.

Exact where the same numbers go through the same arithmetic: the int8
codes and scales of `quantize_weight`, `quantize_act` and
`quantize_model` (leaf for leaf after `convert.from_jax`), the plain
`int8_conv2d` against a float64 convolution of the same integers, answer
ids and greedy tokens. Logits of the int8 forwards within 1e-4 of the
JAX package's (tests/test_full_model_torch_parity.py's tolerance). Where
only exactly rounded fp ops lie between the int8 products (VGG19: bias,
ReLU, max pool) the codes are equal; the derived trunk's depthwise convs
and BatchNorms sum in another order than XLA's, so a code whose x / s
lies at a rounding tie can round the other way there, and that test
replays the JAX package's codes after checking that they differ only at
ties (_CodeReplay). Against the fp32 forward, int8 is not a parity
path: answer agreement and relative logit error are held where
tests/test_quant.py holds them.

fp32, `small_test_config` dims: W and the fixed EF and the unified model
on 32-pixel images (VGG19's five pools), the derived EF (PC_DARTS_cifar,
three cells) on 16-pixel ones. The port's unified model takes only the
supernet or VGG19 (a derived encoder raises), so its quantized tree is
the fixed one. JAX references compiled with LLVM's optimizations off
(tests/test_torch_architect.py's jax_compiled).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lctvqa import quant as j_quant
from lctvqa.config import small_test_config as j_small_config
from lctvqa.models import genotypes as j_genotypes, unified as j_unified
from lctvqa.models import vqa_ef as j_ef, vqa_w as j_w
from lctvqa_torch import convert, quant
from lctvqa_torch.config import small_test_config
from lctvqa_torch.models import genotypes, unified, vqa_ef, vqa_w
from lctvqa_torch.ops import conv as C, int8
from lctvqa_torch.ops import nn as N
from test_torch_architect import jax_compiled
from test_torch_train import one_cpu_thread  # noqa: F401 (autouse)

TOL = 1e-4
B = 8


def _models():
    """name -> (JAX model config, port model config, init seed)."""
    out = {}
    for name, kw in (("w", dict(img_size=32, arch_type="fixed")),
                     ("ef_fixed", dict(img_size=32, arch_type="fixed")),
                     ("unified", dict(img_size=32, arch_type="fixed")),
                     ("ef_derived", dict(arch_type="derived",
                                         darts_layers=3))):
        cfgs = []
        for make, presets in ((j_small_config, j_genotypes),
                              (small_test_config, genotypes)):
            extra = dict(kw)
            if kw["arch_type"] == "derived":
                extra["genotype"] = presets.PC_DARTS_cifar
            cfgs.append(dataclasses.replace(make().model, **extra))
        out[name] = tuple(cfgs)
    return out


MODELS = _models()


def _jax_params(name, seed=0):
    jm = MODELS[name][0]
    key = jax.random.PRNGKey(seed)
    if name == "w":
        return j_w.init_w_model(key, jm), None
    if name == "unified":
        return j_unified.init_unified_model(key, jm)
    return j_ef.init_ef_model(key, jm)


@functools.lru_cache(maxsize=None)
def _jax_quantized(name, seed=0):
    """lctvqa.quant.quantize_model of _jax_params(name, seed), run eagerly
    as the JAX package's export and eval run it (under jit, XLA divides
    the weight scale's abs-max by 127 as a product with the reciprocal,
    an ulp away), shared by the tests of this module."""
    return _np(j_quant.quantize_model(_jax_params(name, seed)[0]))


def _inputs(name, seed=3, b=B):
    mcfg = MODELS[name][0]
    rng = np.random.default_rng(seed)
    img = rng.random((b, mcfg.img_size, mcfg.img_size, 3)).astype(np.float32)
    qst = rng.integers(0, mcfg.qst_vocab_size,
                       (b, mcfg.max_qst_len)).astype(np.int32)
    return img, qst


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the quantization primitives
# ---------------------------------------------------------------------------

def _act_cases():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 5, 5, 3)).astype(np.float32)
    x[2] = 0.0  # a zero sample: the scale floors at 1e-12 / 127
    x[3] *= 1000.0  # an outlier sample
    # exact .5 ties of x / s: abs-max 127 puts s at 1.0, so the codes are
    # the values rounded half to even
    ties = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]],
                    np.float32)
    return {"nhwc": x, "ties": ties,
            "2d": rng.standard_normal((4, 9)).astype(np.float32)}


@pytest.mark.parametrize("case", ["nhwc", "ties", "2d"])
@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["per-tensor", "per-sample"])
def test_quantize_act_bit_equal_jax(case, per_sample):
    x = _act_cases()[case]
    jq, js = j_quant.quantize_act(jnp.asarray(x), per_sample=per_sample)
    tq, ts = C.quantize_act(torch.from_numpy(x), per_sample=per_sample)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if case == "ties":  # half to even, as jnp.round
        np.testing.assert_array_equal(
            tq.numpy(), [[127, 0, 2, 2, 0, -2, -2, 126]])
    # bf16 input: cast to fp32 first, on both sides
    jq, js = j_quant.quantize_act(jnp.asarray(x, jnp.bfloat16), per_sample)
    tq, ts = C.quantize_act(torch.from_numpy(x).bfloat16(), per_sample)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape,out_axis", [((3, 3, 5, 4), 3), ((7, 6), 1),
                                            ((1, 7, 4, 8), 3)],
                         ids=["conv-hwio", "linear", "conv-1x7"])
def test_quantize_weight_bit_equal_jax(shape, out_axis):
    """The JAX weight and its port layout quantize to the same codes and
    scales; a zero channel gets the floor scale and zero codes."""
    rng = np.random.default_rng(2)
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    w[..., 0] = 0.0
    jq, js = j_quant.quantize_weight(jnp.asarray(w), out_axis=out_axis)
    tw = convert.from_jax(w)  # HWIO -> OIHW: the out axis goes to 0
    tq, ts = C.quantize_weight(tw, out_axis=0 if len(shape) == 4 else 1)
    assert tq.dtype == torch.int8 and ts.shape == (shape[-1],)
    np.testing.assert_array_equal(convert.to_jax(tq), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("name", list(MODELS))
def test_quantize_model_equal_jax_leaf_for_leaf(name):
    """Every leaf of quantize_model's tree (int8 codes, scales, biases
    and the leaves left fp) equal to lctvqa.quant.quantize_model's after
    the layout conversion: the eligibility rule (OIHW's w.shape[1] > 1
    for HWIO's w.shape[2] > 1) picks the same convs."""
    params, _ = _jax_params(name)
    want = _jax_quantized(name)
    got = quant.quantize_model(convert.from_jax(_np(params)))
    got_j = convert.to_jax(got)
    assert (jax.tree_util.tree_structure(got_j)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got_j),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    recurrent = "qa" if name == "unified" else "qst"
    assert "w_q" not in str(jax.tree_util.tree_structure(got_j[recurrent]))
    if name == "ef_derived":
        cell0 = got["derived"]["cells"][0]
        dw = [op["dw1"] for op in cell0["ops"] if "dw1" in op]
        pw = [op["pw1"] for op in cell0["ops"] if "pw1" in op]
        assert dw and all("w" in p and p["w"].shape[1] == 1 for p in dw)
        assert pw and all(p["w_q"].dtype == torch.int8 for p in pw)


def test_supernet_refused_by_both_packages():
    params, _ = j_ef.init_ef_model(jax.random.PRNGKey(0),
                                   j_small_config().model)
    with pytest.raises(AssertionError, match="not the search supernet"):
        j_quant.quantize_model(params)
    with pytest.raises(ValueError, match="not the search supernet"):
        quant.quantize_model(convert.from_jax(_np(params)))


# ---------------------------------------------------------------------------
# the int8 products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,padding,dilation", [
    (1, 1, 0, 1), (3, 1, 1, 1), (5, 1, 2, 1), (3, 2, 1, 1), (3, 1, 2, 2),
    (1, 2, 0, 1), ((1, 7), 1, (0, 3), 1), (5, 2, 4, 2)],
    ids=["1x1", "3x3", "5x5", "3x3-stride2", "3x3-dil2", "1x1-stride2",
         "1x7", "5x5-stride2-dil2"])
def test_plain_int8_conv2d_equals_a_float64_conv(k, stride, padding,
                                                 dilation):
    """The patch matrix and the plain product against F.conv2d in
    float64 of the same integers (exact both), and the codes at their
    extremes (+-127)."""
    kh, kw = (k, k) if isinstance(k, int) else k
    gen = torch.Generator().manual_seed(7)
    x = torch.randint(-127, 128, (2, 11, 10, 5), generator=gen,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (6, 5, kh, kw), generator=gen,
                      dtype=torch.int8)
    x[0, 0, 0, :] = 127
    w[0] = -127
    got = int8.int8_conv2d(x, w, stride, padding, dilation)
    want = F.conv2d(x.permute(0, 3, 1, 2).double(), w.double(),
                    stride=stride, padding=padding, dilation=dilation)
    assert got.dtype == torch.int32
    assert torch.equal(got, want.permute(0, 2, 3, 1).to(torch.int32))
    p = int8.patches(x, kh, kw, stride, padding, dilation)
    assert p.dtype == torch.int8
    assert p.numel() == int8.patch_bytes(tuple(x.shape), kh, kw, stride,
                                         padding, dilation)


def test_plain_int8_matmul_is_exact():
    """At the largest depth a model has (fc6 of the full-width VGG19,
    K = 25088) with every code at +-127: the int32 sums of an int64
    reference."""
    gen = torch.Generator().manual_seed(8)
    a = torch.randint(-127, 128, (3, 25088), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (25088, 5), generator=gen, dtype=torch.int8)
    a[0], b[:, 0] = 127, 127
    got = int8.int8_matmul(a, b)
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
    assert got.dtype == torch.int32 and int(got[0, 0]) == 127 * 127 * 25088
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError, match="not torch.int8"):
        int8.int8_matmul(a.float(), b)


def test_int8_conv_and_linear_routes_match_jax():
    """One quantized conv (3x3, padding, bias, out_dtype bf16) and one
    quantized linear (2-D and 3-D inputs) through the dispatch on "w_q",
    against the JAX package's."""
    from lctvqa.ops import conv as j_conv, nn as j_nn
    rng = np.random.default_rng(9)
    cp = {"w": (rng.standard_normal((3, 3, 8, 16)) * 0.1).astype(np.float32),
          "b": (rng.standard_normal(16) * 0.1).astype(np.float32)}
    x = rng.standard_normal((3, 10, 10, 8)).astype(np.float32)
    jq = j_conv.quantize_conv_params(jax.tree_util.tree_map(jnp.asarray, cp))
    for out_dtype, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = j_conv.conv2d(jq, jnp.asarray(x), padding=1,
                             out_dtype=out_dtype)
        got = C.conv2d(C.quantize_conv_params(convert.from_jax(cp)),
                       torch.from_numpy(x), padding=1, dtype=torch.bfloat16,
                       out_dtype=tdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    lp = {"w": (rng.standard_normal((24, 12)) * 0.1).astype(np.float32),
          "b": (rng.standard_normal(12) * 0.1).astype(np.float32)}
    jl = j_nn.quantize_linear_params(jax.tree_util.tree_map(jnp.asarray, lp))
    tl = N.quantize_linear_params(convert.from_jax(lp))
    for shape in ((4, 24), (2, 3, 24)):
        lx = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(
            N.linear(tl, torch.from_numpy(lx), dtype=torch.bfloat16).numpy(),
            np.asarray(j_nn.linear(jl, jnp.asarray(lx))))


# ---------------------------------------------------------------------------
# the int8 forwards
# ---------------------------------------------------------------------------

def test_w_forward_int8_matches_jax_and_agrees_with_fp32():
    jm, tm = MODELS["w"]
    params, _ = _jax_params("w")
    img, qst = _inputs("w")
    want = jax_compiled(lambda p, i, q: j_quant.w_forward_int8(p, jm, i, q),
                        _jax_quantized("w"), jnp.asarray(img),
                        jnp.asarray(qst))
    tp = convert.from_jax(_np(params))
    got = quant.w_forward_int8(quant.quantize_model(tp), tm,
                               torch.from_numpy(img), torch.from_numpy(qst))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(got.argmax(1).numpy(),
                                  np.asarray(want).argmax(1))
    # against the fp32 forward, as tests/test_quant.py holds the JAX one
    with torch.no_grad():
        ref = vqa_w.w_forward(tp, tm, torch.from_numpy(img),
                              torch.from_numpy(qst))
    agree = float((got.argmax(1) == ref.argmax(1)).float().mean())
    rel = float((got - ref).norm() / ref.norm())
    assert agree >= 0.75 and rel < 0.25, (agree, rel)


class _CodeReplay:
    """Holds the port's int8 activation codes to the JAX package's, call
    by call. `record` wraps the JAX package's quantize_act (in a jitted
    forward, through ordered debug callbacks) and keeps each call's
    input, codes and scale; `replay`
    wraps the port's: each call must meet the recorded one in order and
    shape, its scale within REL, its codes equal except where the recorded
    x / s lies within REL (|x / s| + 1) of a rounding boundary (k + 0.5),
    and it goes on with the recorded codes and scale. The depthwise convs
    and BatchNorms between the int8 products sum in other orders in the
    two packages: their outputs, and so the abs-max scales, differ by
    about 1e-6 relative (1.4e-6 seen), and a code at such a near tie
    rounds either way; replaying the codes keeps one flip from hiding
    every later comparison, and each flip is counted."""

    REL = 1e-5

    def __init__(self, monkeypatch):
        self.mp, self.calls, self.at = monkeypatch, [], 0
        self.flips = self.codes = 0

    def record(self):
        from lctvqa.ops import conv as j_conv
        orig = j_conv.quantize_act

        def keep(x, q, sc):
            self.calls.append((np.asarray(x, np.float32), np.asarray(q),
                               np.asarray(sc)))

        def recording(x, per_sample=False):
            q, sc = orig(x, per_sample)
            jax.debug.callback(keep, x, q, sc, ordered=True)
            return q, sc

        self.mp.setattr(j_conv, "quantize_act", recording)

    def replay(self):
        orig = C.quantize_act

        def replaying(x, per_sample=False):
            q, sc = orig(x, per_sample)
            jx, jq, js = self.calls[self.at]
            self.at += 1
            assert q.shape == jq.shape and sc.shape == js.shape
            np.testing.assert_allclose(sc.numpy(), js, rtol=self.REL)
            r = jx / js
            tie = (np.abs(r - np.floor(r) - 0.5)
                   < self.REL * (np.abs(r) + 1))
            differ = q.numpy() != jq
            assert not (differ & ~tie).any(), "a code differs off a tie"
            self.flips += int(differ.sum())
            self.codes += differ.size
            return torch.from_numpy(jq.copy()), torch.from_numpy(js.copy())

        self.mp.setattr(C, "quantize_act", replaying)

    def done(self):
        assert self.at == len(self.calls), (self.at, len(self.calls))
        self.mp.undo()


def test_ef_derived_int8_forward_and_generate_match_jax(monkeypatch):
    """ef_forward_int8's answer and question logits and
    ef_generate_int8's greedy tokens and answer logits over the derived
    trunk, against the JAX package's with its activation codes replayed
    (_CodeReplay: equal but at near ties); answer agreement with fp32."""
    jm, tm = MODELS["ef_derived"]
    params, arch = _jax_params("ef_derived")
    img, qst = _inputs("ef_derived")
    qp = _jax_quantized("ef_derived")
    tp = convert.from_jax(_np(params))
    tq = quant.quantize_model(tp)
    flips = codes_seen = 0
    for fn in ("forward", "generate"):
        codes = _CodeReplay(monkeypatch)
        codes.record()
        if fn == "forward":
            want = jax_compiled(
                lambda p, i, q: j_quant.ef_forward_int8(p, None, jm, i, q),
                qp, jnp.asarray(img), jnp.asarray(qst))
        else:
            want = jax_compiled(
                lambda p, i: j_quant.ef_generate_int8(p, None, jm, i), qp,
                jnp.asarray(img))
        jax.effects_barrier()
        codes.replay()
        if fn == "forward":
            got = quant.ef_forward_int8(tq, None, tm, torch.from_numpy(img),
                                        torch.from_numpy(qst))
            ans = got[0]
        else:
            got = quant.ef_generate_int8(tq, None, tm,
                                         torch.from_numpy(img))
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].argmax(1).numpy(),
                                          np.asarray(want[1]).argmax(1))
        codes.done()
        flips += codes.flips
        codes_seen += codes.codes
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL)
    # a near tie is rare: the REL window around each rounding boundary
    print(f"{flips} of {codes_seen} activation codes at a near tie")
    assert flips <= 1e-3 * codes_seen, (flips, codes_seen)
    with torch.no_grad():
        ref, _ = vqa_ef.ef_forward(tp, None, tm, torch.from_numpy(img),
                                   torch.from_numpy(qst))
    agree = float((ans.argmax(1) == ref.argmax(1)).float().mean())
    rel = float((ans - ref).norm() / ref.norm())
    assert agree >= 0.75 and rel < 0.25, (agree, rel)


def test_ef_fixed_and_unified_int8_generate_match_jax():
    """The fixed EF's int8 answer logits and the unified model's int8
    greedy stream, against the JAX package's."""
    jm, tm = MODELS["ef_fixed"]
    params, _ = _jax_params("ef_fixed", seed=1)
    img, qst = _inputs("ef_fixed")
    want, _ = jax_compiled(
        lambda p, i, q: j_quant.ef_forward_int8(p, None, jm, i, q),
        _jax_quantized("ef_fixed", 1), jnp.asarray(img), jnp.asarray(qst))
    got, _ = quant.ef_forward_int8(
        quant.quantize_model(convert.from_jax(_np(params))), None, tm,
        torch.from_numpy(img), torch.from_numpy(qst))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)

    jm, tm = MODELS["unified"]
    params, _ = _jax_params("unified", seed=2)
    img, _ = _inputs("unified")
    want = jax_compiled(
        lambda p, i: j_unified.unified_generate(p, None, jm, i),
        _jax_quantized("unified", 2), jnp.asarray(img))
    with torch.no_grad():
        got = unified.unified_generate(
            quant.quantize_model(convert.from_jax(_np(params))), None, tm,
            torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
