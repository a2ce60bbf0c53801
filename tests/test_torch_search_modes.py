"""The supernet's three other ways of running the same math in the port
(`remat_cells`, `pack_conv_branches`, `fuse_mixed_ops`: models/search.py,
models/search_fused.py, models/derived.py) against the JAX package on
the CPU in fp32, on the same seeded weights (the port's init, carried
across with `convert`) and inputs: each mode's network forward within
1e-4, its parameter and arch gradients (of sum(tanh(out))) within the
JAX package's own tolerance for that mode (tests/test_search.py,
tests/test_search_fused.py), and the derived net with `remat_cells` at
the supernet's remat tolerance.

Dims: `darts_init_ch` 4, `darts_layers` 2, 16 px, B = 4, the supernet cut
to two nodes a cell as in the training tests (both cells reduction cells,
the second after a reduction: each node has a stride-2 group of two
edges, the second node a stride-1 edge besides). Each JAX reference is
compiled once, with LLVM's optimizations off. The steps, the CLI and the
experiment with these flags are tests/test_torch_search_modes_steps.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lctvqa.config import small_test_config as j_small_config
from lctvqa.models import derived as j_derived
from lctvqa.models import genotypes as j_genotypes
from lctvqa.models import search as j_search
from lctvqa.models import search_fused as j_fused
from lctvqa_torch import convert
from lctvqa_torch.config import small_test_config
from lctvqa_torch.models import derived as t_derived
from lctvqa_torch.models import genotypes
from lctvqa_torch.models import search as t_search
from lctvqa_torch.models import search_fused as t_fused
from lctvqa_torch.optim.optimizers import tree_leaves, tree_map
from test_torch_train import jax_ref, one_cpu_thread  # noqa: F401
# (fixtures, the second autouse)

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
DIMS = {"darts_init_ch": 4, "darts_layers": 2, "img_size": 16,
        "darts_steps": 2, "darts_multiplier": 2}
B = 4
FWD_TOL = 1e-4


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _remat_grads_close(a, b, arch: bool):
    """tests/test_search.py::test_remat_cells_matches_no_remat's."""
    atol = 1e-4 if arch else 1e-4 * max(1.0, float(np.abs(a).max()))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)


def _pack_grads_close(a, b, arch: bool):
    """tests/test_search.py::test_pack_conv_branches_matches_unpacked's."""
    atol = 2e-3 if arch else 2e-3 * max(1.0, float(np.abs(a).max()))
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=atol)


def _fused_grads_close(a, b, arch: bool):
    """tests/test_search_fused.py::test_fused_gradients_match's."""
    assert np.abs(a - b).max() <= 3e-5 + 3e-4 * np.abs(a).max()


def _fused_fold_grads_close(a, b, arch: bool):
    """tests/test_search_fused.py::test_fused_fold_gradients_match's."""
    assert np.abs(a - b).max() <= 1e-4 + 2e-3 * np.abs(a).max()


# mode -> (config flags, JAX network, port network, gradient check)
MODES = {
    "remat": ({"remat_cells": True}, j_search.network_apply,
              t_search.network_apply, _remat_grads_close),
    "pack": ({"pack_conv_branches": True}, j_search.network_apply,
             t_search.network_apply, _pack_grads_close),
    "fused": ({"fuse_mixed_ops": True}, j_fused.network_apply_fused,
              t_fused.network_apply_fused, _fused_fold_grads_close),
    "fused_unfolded": ({"fuse_mixed_ops": True, "fold_bn_mixture": False},
                       j_fused.network_apply_fused,
                       t_fused.network_apply_fused, _fused_grads_close),
}


def _mcfg(**kw):
    return dataclasses.replace(j_small_config().model, **DIMS, **kw)


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, DIMS["img_size"], DIMS["img_size"], 3)).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_value_and_grads(net, x, *trees):
    """(net(*trees, x), d sum(tanh(net)) / d each tree), jitted once."""
    def loss(*ts):
        out = net(*ts, jnp.asarray(x))
        return jnp.sum(jnp.tanh(out)), out

    fn = jax.value_and_grad(loss, argnums=tuple(range(len(trees))),
                            has_aux=True)
    (_, out), grads = jax.jit(fn).lower(*trees).compile(FAST_COMPILE)(
        *trees)
    return np.asarray(out), _np(grads)


def _port_value_and_grads(net, x, *trees):
    """The same on the port: trees in the JAX layout -> (out, grads in the
    JAX layout)."""
    ports = [convert.from_jax(t) for t in trees]
    leaves = [leaf.requires_grad_() for t in ports for leaf in
              tree_leaves(t)]
    out = net(*ports, torch.from_numpy(x))
    grads = iter(torch.autograd.grad(torch.tanh(out).sum(), leaves,
                                     allow_unused=True))
    got = [convert.to_jax(tree_map(
        lambda p: (lambda g: torch.zeros_like(p) if g is None else g)(
            next(grads)).detach(), t)) for t in ports]
    return out.detach().numpy(), got


def _supernet_trees():
    """The port's seeded init in the JAX layout; the arch drawn off its
    1e-3 init, so that the mixture is not uniform."""
    gen = torch.Generator().manual_seed(5)
    cfg = _t_mcfg()
    params = t_search.network_init(gen, cfg)
    arch = {k: torch.randn(v.shape, generator=gen)
            for k, v in t_search.arch_init(gen, cfg).items()}
    return _np(convert.to_jax(params)), _np(convert.to_jax(arch))


def _t_mcfg(**kw):
    return dataclasses.replace(small_test_config().model, **DIMS, **kw)


def _check_grads(check, got, want, arch: bool):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want)
    for (path, a), b in zip(flat_got, flat_want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        try:
            check(b, a, arch)
        except AssertionError as e:
            raise AssertionError(jax.tree_util.keystr(path)) from e


@pytest.mark.parametrize("mode", sorted(MODES))
def test_network_mode_matches_jax(mode, jax_ref):
    """The mode's network on both packages, every flag set alike."""
    flags, j_net, t_net, check = MODES[mode]
    params, arch = jax_ref("supernet_trees", _supernet_trees)
    cfg = _mcfg(**flags)
    t_cfg = _t_mcfg(**flags)
    x = _x()
    want, (wp, wa) = jax_ref(("supernet", mode), lambda: _jax_value_and_grads(
        lambda p, a, xx: j_net(p, a, cfg, xx), x, params, arch))
    got, (gp, ga) = _port_value_and_grads(
        lambda p, a, xx: t_net(p, a, t_cfg, xx), x, params, arch)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    _check_grads(check, gp, wp, arch=False)
    _check_grads(check, ga, wa, arch=True)


def test_derived_remat_cells_matches_jax():
    """The derived net (PC_DARTS_cifar, four nodes a cell) with
    `remat_cells` on both packages: forward 1e-4, gradients at the remat
    tolerance."""
    dims = dict(DIMS, darts_steps=4, darts_multiplier=4)
    cfg = dataclasses.replace(j_small_config().model, **dims,
                              remat_cells=True)
    t_cfg = dataclasses.replace(small_test_config().model, **dims,
                                remat_cells=True)
    params = _np(convert.to_jax(t_derived.derived_network_init(
        torch.Generator().manual_seed(3), t_cfg, genotypes.PC_DARTS_cifar)))
    x = _x(1)
    want, (wp,) = _jax_value_and_grads(
        lambda p, xx: j_derived.derived_network_apply(
            p, cfg, j_genotypes.PC_DARTS_cifar, xx), x, params)
    got, (gp,) = _port_value_and_grads(
        lambda p, xx: t_derived.derived_network_apply(
            p, t_cfg, genotypes.PC_DARTS_cifar, xx), x, params)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    _check_grads(_remat_grads_close, gp, wp, arch=False)


def test_packed_kernels_interleave_the_branches():
    """_packed_dw1_kernel's and _packed_pw_matrix's channel c*NB + b is
    branch b's channel c (c-major, b-minor), dilated taps spread out, as
    the JAX package's are after HWIO -> OIHW."""
    tp = t_search.mixed_op_init(torch.Generator().manual_seed(9), 12, 1, 4)
    p = _np(convert.to_jax(tp))
    cs = 3
    for j_fn, t_fn in ((j_search._packed_dw1_kernel,
                        t_search._packed_dw1_kernel),
                       (j_search._packed_dw2_kernel,
                        t_search._packed_dw2_kernel)):
        want = np.asarray(j_fn(p, cs)).transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(t_fn(tp, cs).numpy(), want)
    blocks = [p[pr]["pw1" if pr.startswith("sep") else "pw"]["w"]
              for pr in j_search._PACKED_BRANCHES]
    want = np.asarray(j_search._packed_pw_matrix(blocks, cs)).T
    got = t_search._packed_pw_matrix(
        [tp[pr]["pw1" if pr.startswith("sep") else "pw"]["w"]
         for pr in t_search._PACKED_BRANCHES], cs)
    np.testing.assert_array_equal(got[:, :, 0, 0].numpy(), want)
    assert float(got[1, 0, 0, 0]) == 0.0  # branch 1's row, branch 0's col


@pytest.mark.parametrize("stride", [1, 2])
def test_cpu_bf16_dilated_depthwise_gradient_sums_in_fp32(stride):
    """ops.conv.conv2d of bf16 operands on the CPU sums in fp32, as the
    card does: a dilated depthwise convolution's weight gradient (the
    dil_conv primitives') is the fp32 product of the rounded operands,
    rounded once to bf16 (2^-7 of its scale). PyTorch's own CPU route
    summed it in bf16, 28% off at these sizes, and the supernet's bf16
    gradients on the CPU reached 1e33."""
    from lctvqa_torch.ops import conv as t_conv

    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.maximum(rng.standard_normal(
        (8, 32, 32, 2)), 0).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 1, 5, 5)).astype(
        np.float32)).requires_grad_()
    y = t_conv.depthwise_conv2d({"w": w}, x, stride=stride, padding=4,
                                dilation=2, dtype=torch.bfloat16)
    got, = torch.autograd.grad(y.sum(), w)
    wr = w.detach().to(torch.bfloat16).float().requires_grad_()
    want, = torch.autograd.grad(torch.nn.functional.conv2d(
        x.to(torch.bfloat16).float().permute(0, 3, 1, 2), wr,
        stride=stride, padding=4, dilation=2, groups=2).sum(), wr)
    assert y.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2.0 ** -7 * scale
