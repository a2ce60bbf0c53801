"""The VGG epilogue (lctvqa_torch/ops/cuda_vgg.py) and its route in
`models/vgg.py::vgg19_features`, on the CPU.

Contract: the operator `lctvqa_torch::vgg_epilogue` (here its plain
version) after a bias-free convolution equals the composition it
replaces (`conv.conv2d` with its bias, fp32 ReLU, `conv.max_pool` in
fp32, the next convolution's cast) bit for bit, in bf16 and fp32, pooled
or not, at odd sizes (floor mode); its fake gives the shapes and dtypes
and `torch.export` traces it. `vgg19_features` equals its composition
before the epilogue bit for bit in both dtypes, at a size where the
adaptive pool averages several cells too, with 16 epilogues a forward; a
trunk that needs a gradient, int8 params, fp16 and `second_order` keep
the composition, with the same outputs and gradients. The kernel itself
is checked on the card by tests/test_torch_cuda_kernels.py and
chip_smoke.py.
"""

import pytest
import torch

from lctvqa_torch.models import vgg
from lctvqa_torch.ops import conv as C
from lctvqa_torch.ops import cuda_vgg
from lctvqa_torch.ops import nn as N
from test_torch_train import one_cpu_thread  # noqa: F401 (autouse)

f32, bf16 = torch.float32, torch.bfloat16
# (input, output) dtypes the route takes: bf16 between convolutions, bf16
# into the fp32 adaptive pool, fp32 throughout
DTYPE_PAIRS = [(bf16, bf16), (bf16, f32), (f32, f32)]


def _features_before(params, x, gen=None, deterministic=True, dtype=None):
    """`vgg19_features` as it was before the epilogue: each convolution
    with its bias, ReLU in fp32, fp32 max pools."""
    conv_i = 0
    for v in vgg.VGG19_CFG:
        if v == "M":
            x = C.max_pool(x, 2, 2)
        else:
            x = torch.relu(C.conv2d(params["features"][conv_i], x, stride=1,
                                    padding=1, dtype=dtype))
            conv_i += 1
    x = C.adaptive_avg_pool(x, 7)
    x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
    x = torch.relu(N.linear(params["fc6"], x, dtype=dtype))
    x = N.dropout(x, 0.5, gen, deterministic)
    x = torch.relu(N.linear(params["fc7"], x, dtype=dtype))
    return N.dropout(x, 0.5, gen, deterministic)


@pytest.fixture
def epilogues(monkeypatch):
    """Counts `vgg19_features`' calls of the operator."""
    calls = []
    op = cuda_vgg.vgg_epilogue

    def counted(*args):
        calls.append(args[2])
        return op(*args)

    monkeypatch.setattr(cuda_vgg, "vgg_epilogue", counted)
    return calls


def _conv_case(shape, seed=0):
    n, h, w, c = shape
    gen = torch.Generator().manual_seed(seed)
    p = C.torch_conv_init(gen, 3, 3, 5, c, bias=True)
    return p, torch.randn(n, h, w, 5, generator=gen)


@pytest.mark.parametrize("pool", [False, True], ids=["relu", "pool"])
@pytest.mark.parametrize("dtypes", DTYPE_PAIRS,
                         ids=lambda d: f"{d[0]}-{d[1]}".replace("torch.", ""))
@pytest.mark.parametrize("shape", [(2, 6, 10, 16), (3, 7, 5, 8)],
                         ids=["even", "odd"])
def test_operator_equals_the_composition(shape, dtypes, pool):
    """Operator after the bias-free convolution against the convolution
    with its bias, ReLU, the fp32 pool and the cast to the next
    convolution's dtype: equal bit for bit, and in `out_dtype`."""
    in_dtype, out_dtype = dtypes
    dt = None if in_dtype == f32 else in_dtype
    p, x = _conv_case(shape)
    want = torch.relu(C.conv2d(p, x, stride=1, padding=1, dtype=dt))
    if pool:
        want = C.max_pool(want, 2, 2)
    want = want.to(out_dtype)
    y = C.conv2d({"w": p["w"]}, x, stride=1, padding=1, dtype=dt,
                 out_dtype=dt).contiguous()
    assert y.dtype == in_dtype
    got = cuda_vgg.VGG_EPILOGUE_OP(y, p["b"], pool, out_dtype)
    assert got.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(cuda_vgg.vgg_epilogue_plain(y, p["b"], pool,
                                                   out_dtype), want)


@pytest.mark.parametrize("case", [((2, 5, 7, 8), bf16, True, bf16),
                                  ((1, 4, 4, 16), f32, False, f32),
                                  ((3, 6, 4, 8), bf16, True, f32)],
                         ids=["bf16-pool-odd", "fp32-relu", "bf16-to-fp32"])
def test_opcheck_and_fake(case):
    """opcheck (schema, the fake against the CPU implementation, dynamic
    shapes), the fake's shape and dtype under FakeTensorMode, and the
    fake's refusals."""
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    shape, in_dtype, pool, out_dtype = case
    gen = torch.Generator().manual_seed(3)
    y = torch.randn(*shape, generator=gen).to(in_dtype)
    b = torch.randn(shape[-1], generator=gen)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", ".*an autograd kernel was not")
        torch.library.opcheck(cuda_vgg.VGG_EPILOGUE_OP,
                              (y, b, pool, out_dtype))
    n, h, w, c = shape
    with FakeTensorMode() as mode:
        out = cuda_vgg.VGG_EPILOGUE_OP(mode.from_tensor(y),
                                       mode.from_tensor(b), pool, out_dtype)
    assert out.dtype == out_dtype
    assert tuple(out.shape) == ((n, h // 2, w // 2, c) if pool else shape)
    for bad in ((y, b.to(bf16), pool, out_dtype),
                (y, b[:-1], pool, out_dtype),
                (y[:, :1, :1], b, True, out_dtype),
                (y, b, pool, torch.float16)):
        with pytest.raises(ValueError, match="vgg_epilogue"):
            cuda_vgg._fake(*bad)


def test_operator_exports_with_a_symbolic_batch():
    """A function of the operator traced by torch.export with a dynamic
    batch holds the operator and equals the eager call at other
    batches."""
    class Epilogue(torch.nn.Module):
        def forward(self, y, b):
            return cuda_vgg.vgg_epilogue(y, b, True, bf16)

    gen = torch.Generator().manual_seed(4)
    b = torch.randn(16, generator=gen)
    batch = torch.export.Dim("batch", min=1, max=8)
    program = torch.export.export(
        Epilogue(), (torch.randn(2, 6, 6, 16, generator=gen).to(bf16), b),
        dynamic_shapes=({0: batch}, None))
    ops = [n.target for n in program.graph.nodes
           if n.op == "call_function"]
    assert ops.count(cuda_vgg.VGG_EPILOGUE_OP) == 1
    for n in (1, 5):
        y = torch.randn(n, 6, 6, 16, generator=gen).to(bf16)
        assert torch.equal(program.module()(y, b),
                           cuda_vgg.vgg_epilogue_plain(y, b, True, bf16))


@pytest.mark.parametrize("dtype", [bf16, f32, None],
                         ids=["bfloat16", "float32", "none"])
@pytest.mark.parametrize("size,width,launches",
                         [(32, 0.125, 16), (40, 1 / 16, 14),
                          (256, 0.125, 16)],
                         ids=["32px", "40px-narrow", "256px"])
def test_features_equal_the_composition(epilogues, size, width, launches,
                                        dtype):
    """vgg19_features against its composition before the epilogue, bit
    for bit: at 32 px; at 40 px (odd sizes from the fourth pool on) with
    the first block's 4 channels below the kernel's 8, so those two
    convolutions keep the composition; at 256 px, where the adaptive pool
    averages 2x2 cells of the last block's fp32 output. An epilogue for
    each convolution that takes the route, 5 of the 16 pooled."""
    gen = torch.Generator().manual_seed(5)
    params = vgg.vgg19_init(gen, width, fc_dim=16)
    x = torch.randn(2, size, size, 3, generator=gen)
    want = _features_before(params, x, dtype=dtype)
    got = vgg.vgg19_features(params, x, dtype=dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert len(epilogues) == launches and sum(epilogues) == 5 - (
        16 - launches) // 2


def _grad_params(width=0.125):
    gen = torch.Generator().manual_seed(6)
    params = vgg.vgg19_init(gen, width, fc_dim=16)
    return {"features": [{k: t.clone().requires_grad_() for k, t in p.items()}
                         for p in params["features"]],
            "fc6": params["fc6"], "fc7": params["fc7"]}


@pytest.mark.parametrize("dtype", [bf16, None], ids=["bfloat16", "float32"])
def test_a_trunk_being_trained_keeps_the_composition(epilogues, dtype):
    """Params that require a gradient: no epilogue; the features and the
    gradients of every conv leaf equal the composition's bit for bit.
    Under no_grad the same params take the route again."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 32, 32, 3, generator=gen)
    grads = []
    for fn in (vgg.vgg19_features, _features_before):
        params = _grad_params()
        out = fn(params, x, dtype=dtype)
        out.square().sum().backward()
        grads.append([t.grad for p in params["features"] for t in p.values()])
    assert not epilogues
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    with torch.no_grad():
        vgg.vgg19_features(_grad_params(), x, dtype=dtype)
    assert len(epilogues) == 16


def test_an_image_that_needs_a_gradient_keeps_the_composition(epilogues):
    gen = torch.Generator().manual_seed(8)
    params = vgg.vgg19_init(gen, 0.125, fc_dim=16)
    x = torch.randn(1, 32, 32, 3, generator=gen).requires_grad_()
    out = vgg.vgg19_features(params, x, dtype=bf16)
    assert not epilogues
    assert torch.equal(out, _features_before(params, x, dtype=bf16))


@pytest.mark.parametrize("route", ["int8", "float16", "second_order"])
def test_other_routes_keep_the_composition(epilogues, route):
    """int8 params (`quantize_conv_params`), an fp16 compute dtype and a
    `second_order` scope (stage 3 takes no kernel): no epilogue, and the
    composition's features."""
    gen = torch.Generator().manual_seed(9)
    params = vgg.vgg19_init(gen, 0.125, fc_dim=16)
    x = torch.randn(2, 32, 32, 3, generator=gen)
    dtype = torch.float16 if route == "float16" else None
    if route == "int8":
        params = dict(params, features=[C.quantize_conv_params(p)
                                        for p in params["features"]])
    scope = C.second_order() if route == "second_order" else None
    with scope or torch.no_grad():
        got = vgg.vgg19_features(params, x, dtype=dtype)
        want = _features_before(params, x, dtype=dtype)
    assert not epilogues
    assert torch.equal(got, want)
