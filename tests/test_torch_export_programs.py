"""The serving functions as `torch.export` programs
(lctvqa_torch/export.py::export_programs) and the six serving kernels as
registered operators of the namespace `lctvqa_torch`, on the CPU.

Contract: `torch.library.opcheck` passes on each operator (its CPU
implementation is the kernel's plain version); every function of every
fp artifact family traces with a symbolic batch, its graph holds the
`lctvqa_torch` operators that the eager `ServingModel` call dispatches,
and the program equals that call bit for bit at batches 1, 2 and 5; the
W and darts-EF programs match the JAX package's serving functions
(`lctvqa/export.py::_build_fns`, jitted, on the same params: floats
within 1e-4, tokens and ids exactly); a question one id longer than the
program's raises before anything is computed. Writing the programs
into an artifact, reading them back and the int8 and fp32 programs are
tests/test_torch_program_artifacts.py's.

Sizes are `small_test_config`'s; the supernet is cut to two nodes a cell
(two reduction cells, each with one stride-1 edge on the node operator),
as in the training tests, because tracing costs time per graph node.
"""

import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lctvqa import export as j_export
from lctvqa.config import small_test_config as j_small_config
from lctvqa_torch import convert
from lctvqa_torch.config import small_test_config
from lctvqa_torch.export import ServingModel, export_programs
from lctvqa_torch.models import genotypes, search, unified, vqa_ef, vqa_w
from lctvqa_torch.ops import (conv, cuda_bn, cuda_generate, cuda_lstm,
                              cuda_mixedop)
from test_torch_train import one_cpu_thread  # noqa: F401 (autouse)

# the supernet's nodes per cell and nodes concatenated at its output
SMALL_SUPERNET = {"darts_steps": 2, "darts_multiplier": 2}
KERNEL_FLAGS = {"use_pallas_lstm": True, "pallas_seq_lstm": True,
                "pallas_generate": True, "pallas_mixed_op": True,
                "fold_bn_mixture": True}
# LLVM's optimizations off for the JAX references
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
# name -> (family, encoder dims, ServingModel flags, BatchNorm switch)
CASES = {
    "w": ("w", {"arch_type": "fixed", "img_size": 32}, {}, False),
    "w_kernels": ("w", {"arch_type": "fixed", "img_size": 32},
                  KERNEL_FLAGS, True),
    "ef": ("ef", {"arch_type": "fixed", "img_size": 32}, {}, False),
    "darts": ("ef", {"arch_type": "darts", **SMALL_SUPERNET},
              KERNEL_FLAGS, True),
    "derived": ("ef", {"arch_type": "derived",
                       "genotype": genotypes.PC_DARTS_cifar},
                KERNEL_FLAGS, True),
    "unified": ("unified", {"arch_type": "fixed", "img_size": 32},
                KERNEL_FLAGS, True),
}
# the operators each program's graph holds, counted at these sizes (T = 8
# steps; the cut supernet's two cells: 20 affine-free batch-statistics
# BatchNorms and one node of stride-1 edges each; the derived net's two
# pool BatchNorms)
GRAPH_OPS = {
    ("w", "answer_logits"): {"lstm_cell": 8},
    ("w_kernels", "answer_logits"): {"lstm_seq_final": 1},
    ("ef", "answer_logits"): {"lstm_cell": 8},
    ("ef", "generate"): {"lstm_cell": 16},
    ("darts", "answer_logits"): {"batchnorm": 20, "mixed_node": 2,
                                 "lstm_seq": 1},
    ("darts", "generate"): {"batchnorm": 20, "mixed_node": 2, "lstm_seq": 1,
                            "greedy_generate": 1},
    ("derived", "answer_logits"): {"batchnorm": 2, "lstm_seq": 1},
    ("derived", "generate"): {"batchnorm": 2, "lstm_seq": 1,
                              "greedy_generate": 1},
    ("unified", "generate"): {"greedy_generate": 1},
}


@contextlib.contextmanager
def bn_switch(on: bool):
    """The process-wide BatchNorm kernel switch, restored after."""
    was, conv.USE_PALLAS_BN = conv.USE_PALLAS_BN, on
    try:
        yield
    finally:
        conv.USE_PALLAS_BN = was


class _CountOps(TorchDispatchMode):
    """Counts the `lctvqa_torch` operators dispatched in its scope."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "lctvqa_torch":
            name = func._schema.name.split("::")[1]
            self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _graph_ops(program) -> dict:
    counts = {}
    for node in program.graph.nodes:
        target = getattr(node.target, "namespace", None)
        if node.op == "call_function" and target == "lctvqa_torch":
            name = node.target._schema.name.split("::")[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


def _mcfg(make, dims):
    return dataclasses.replace(make().model, compute_dtype="float32", **dims)


def _artifact(name):
    """-> (artifact dict in the JAX layout, its params and arch trees for
    the JAX references), from the port's initializers; a darts EF's
    arch parameters drawn anew, so that its mixture is not uniform."""
    family, dims, _, _ = CASES[name]
    mcfg = _mcfg(small_test_config, dims)
    gen = torch.Generator().manual_seed(2)
    if family == "w":
        params, arch = vqa_w.init_w_model(gen, mcfg), None
    elif family == "ef":
        params, arch = vqa_ef.init_ef_model(gen, mcfg)
    else:
        params, arch = unified.init_unified_model(gen, mcfg)
    if arch is not None:
        arch = {k: torch.randn(v.shape, generator=gen)
                for k, v in arch.items()}
    bundle = {"params": convert.to_jax(params)}
    if arch is not None:
        bundle["arch"] = convert.to_jax(arch)
    meta = {"artifact_version": 1, "family": family, "int8": False,
            "img_size": mcfg.img_size, "max_qst_len": mcfg.max_qst_len,
            "qst_vocab_size": mcfg.qst_vocab_size,
            "ans_vocab_size": mcfg.ans_vocab_size,
            "arch_type": mcfg.arch_type}
    return ({"exported": {}, "params": bundle, "meta": meta},
            (bundle["params"], bundle.get("arch")))


class _Traced:
    """Each case's ServingModel and programs, made at first use."""

    def __init__(self):
        self.cases = {}

    def __getitem__(self, name):
        if name not in self.cases:
            _, dims, flags, bn = CASES[name]
            artifact, jax_trees = _artifact(name)
            model = ServingModel(artifact, "cpu", compute_dtype="float32",
                                 genotype=dims.get("genotype"), **flags)
            with bn_switch(bn):
                programs = export_programs(model, max_batch=8)
            self.cases[name] = (model, programs, jax_trees)
        return self.cases[name]


@pytest.fixture(scope="module")
def traced():
    return _Traced()


def _inputs(model, b, seed):
    rng = np.random.default_rng(seed)
    s, steps = model.config.img_size, model.config.max_qst_len
    u8 = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    qst = rng.integers(0, model.config.qst_vocab_size, (b, steps),
                       dtype=np.int32)
    return u8, qst


def _args(fn, u8, qst):
    u8 = torch.from_numpy(u8)
    return (u8, torch.from_numpy(qst)) if fn == "answer_logits" else (u8,)


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

def _op_cases():
    gen = torch.Generator().manual_seed(0)
    emb, hid, b, steps = 6, 8, 3, 4

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    def wanted(*tensors):  # opcheck's autograd test needs such an input
        return [t.clone().requires_grad_() for t in tensors]

    w = cuda_lstm.CellWeights(*wanted(randn(emb, 4 * hid),
                                      randn(hid, 4 * hid), randn(4 * hid)))
    x, h, c, xs = randn(b, emb), randn(b, hid), randn(b, hid), randn(b, steps,
                                                                     emb)
    qst = {"lstm": {"layers": [{"w_ih": w.w_ih.detach(), "w_hh": w.w_hh,
                                "b_ih": w.b.detach(),
                                "b_hh": torch.zeros(4 * hid)}]},
           "word2vec": {"table": randn(13, emb)},
           "fc2": {"w": randn(hid, 13), "b": randn(13)}}
    d = cuda_generate.decode_weights(qst, torch.bfloat16)
    cell = wanted(*d.cell)
    ops = [cuda_mixedop.node_weights(
        search.mixed_op_init(gen, 8, 1, 4)) for _ in range(2)]
    edges = wanted(randn(2, 5, 6, 8), randn(2, 5, 6, 8))
    return {
        "lstm_cell": (cuda_lstm.LSTM_CELL_OP, (x, h, c, *w)),
        "lstm_seq_final": (cuda_lstm.LSTM_SEQ_FINAL_OP, (xs, h, c, *w)),
        "lstm_seq": (cuda_lstm.LSTM_SEQ_OP, (xs, h, c, *w)),
        "greedy_generate": (cuda_generate.GREEDY_GENERATE_OP,
                            (h, d.x0, *cell, d.fc2_w, d.fc2_b, d.table, 5)),
        "mixed_node": (cuda_mixedop.MIXED_NODE_OP,
                       (edges, [o.dw for o in ops], [o.pw for o in ops],
                        torch.softmax(randn(2, 8), 1), 2)),
        "batchnorm": (cuda_bn.BATCHNORM_OP,
                      (*wanted(randn(2, 5, 6, 8)), torch.bfloat16, 1e-5)),
    }


OPS = ("lstm_cell", "lstm_seq_final", "lstm_seq", "greedy_generate",
       "mixed_node", "batchnorm")


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    """The schema, the fake against the CPU implementation, autograd's
    registration (no gradient comes out: the operators are the no-grad
    route) and AOT dispatch with dynamic shapes."""
    op, args = _op_cases()[name]
    with warnings.catch_warnings():
        # the AOT check backprops through the operator, which has no
        # autograd kernel: PyTorch warns, and no gradient is compared
        warnings.filterwarnings("ignore", ".*an autograd kernel was not")
        torch.library.opcheck(op, args)


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------

PROGRAMS = sorted(GRAPH_OPS)


@pytest.mark.parametrize("case", PROGRAMS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_program_equals_the_eager_call(traced, case):
    """The graph holds the operators the eager call dispatches; at batches
    1, 2 and 5 the program's outputs are the eager call's, bit for bit,
    with its dtypes."""
    name, fn = case
    model, programs, _ = traced[name]
    assert sorted(programs) == model.functions
    program = programs[fn]
    assert _graph_ops(program) == GRAPH_OPS[case]
    # the weights are the program's state, not lifted constants
    assert "params__img_fc__w" in program.state_dict
    assert all(t.numel() == 3 for t in program.constants.values())
    run = program.module()
    with bn_switch(CASES[name][3]):
        for b, seed in ((1, 10), (2, 11), (5, 12)):
            args = _args(fn, *_inputs(model, b, seed))
            with _CountOps() as eager:
                want = _tuple(getattr(model, fn)(*args))
            got = _tuple(run(*args))
            assert eager.counts == GRAPH_OPS[case]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape[0] == b
                assert torch.equal(g, w), (name, fn, b)


@pytest.mark.parametrize("name", ["w", "darts"])
def test_programs_match_the_jax_serving_functions(traced, name):
    """At batch 5, on the same params: floats within 1e-4, tokens and ids
    exactly."""
    family, dims, _, bn = CASES[name]
    model, programs, (params, arch) = traced[name]
    mcfg = j_export._serving_config(_mcfg(j_small_config, dims))
    fns = j_export._build_fns(family, mcfg, has_arch=arch is not None)
    bundle = {"params": params, **({"arch": arch} if arch is not None
                                   else {})}
    u8, qst = _inputs(model, 5, 20)
    for fn, program in programs.items():
        args = (bundle, jnp.asarray(u8), jnp.asarray(qst))
        args = args if fn == "answer_logits" else args[:2]
        want = jax.jit(fns[fn]).lower(*args).compile(FAST_COMPILE)(*args)
        with bn_switch(bn):
            got = _tuple(program.module()(*_args(fn, u8, qst)))
        for g, w in zip(got, _tuple(want)):
            w = np.asarray(w)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                           atol=1e-4)
            else:
                np.testing.assert_array_equal(g.numpy(), w)


def test_a_longer_question_raises_before_computing(traced):
    """The program asserts its inputs' trailing shapes: T + 1 ids raise,
    and no operator runs."""
    model, programs, _ = traced["w"]
    u8, qst = _inputs(model, 2, 30)
    longer = np.concatenate([qst, qst[:, :1]], axis=1)
    run = programs["answer_logits"].module()
    with _CountOps() as seen, pytest.raises((AssertionError, RuntimeError),
                                            match="qst|shape"):
        run(*_args("answer_logits", u8, longer))
    assert seen.counts == {}
