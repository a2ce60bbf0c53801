"""Data and tensor parallelism of the port (lctvqa_torch/parallel/) on the
CPU with gloo: two ranks, each on its half of a global batch of 8,
against one process on the whole batch, as tests/test_mesh.py holds the
JAX package's sharded steps to its single-device ones.

One spawn of two ranks per module runs every multi-rank check
(`ranks`); each test reads what the ranks wrote. The model is
tests/test_mesh.py's: `small_test_config` widths cut to one reduction
cell of two nodes, 32-pixel images (the W model's VGG19 needs 32), fp32.
Randomness is removed as the port's parity tests remove it: dropout as
the identity (W's VGG has a hard-coded rate of 0.5) and the sampled
pseudo questions of stage 2 taken greedily, so that the ranks' own
streams (seeded from seed and rank) do not enter the comparison.
Tolerances are tests/test_mesh.py's: losses rtol 1e-5; parameters rtol
2e-4, atol 1e-5; the arch atol 1e-6. The two ranks' parameters must be
the same bits. The ranks' stage 1 is also held against the JAX
package's single-device stage 1 at 1e-4, on its initial weights carried
across with `convert`. With `pallas_mixed_op` (the mixed-op node
kernels, whose plain version the CPU runs) the node's batch statistics
are the global batch's: stage 1 and the darts family's train step on two
ranks against one process, stage 1 against the JAX package's (whose
flag takes its XLA path off a TPU, as its sharded run does), and one
node call's output and gradients against the concatenated batch.
"""

import contextlib
import dataclasses
import multiprocessing
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from lctvqa_torch import convert
from lctvqa_torch.config import Config, ModelConfig, TrainConfig
from lctvqa_torch.data import pipeline, pipeline_npy, synthetic
from lctvqa_torch.ops import cuda_bn, nn as t_nn
from lctvqa_torch.optim.optimizers import tree_leaves, tree_map
from lctvqa_torch.parallel import distributed, mesh as mesh_lib, tp as tp_lib

WORLD = 2
B = 8
LR = 1e-3
# the ranks' join: two rank processes that import torch and run every
# check take 15-25 s on one core each
JOIN_SECONDS = 240


def model_config(**kw) -> ModelConfig:
    """tests/test_mesh.py's model in the port's config."""
    return ModelConfig(
        img_embed_size=16, word_embed_size=8, lstm_hidden_size=16,
        max_qst_len=6, qst_vocab_size=32, ans_vocab_size=16, img_size=32,
        darts_init_ch=4, darts_layers=1, darts_steps=2, darts_multiplier=2,
        compute_dtype="float32", vgg_width_mult=1 / 16, vgg_fc_dim=32,
        dropout_rate=0.0, **kw)


def config(**model_kw) -> Config:
    return Config(model=model_config(**model_kw),
                  train=TrainConfig(batch_size=B, skip_stage3=False))


def global_batch(seed: int, mcfg: ModelConfig) -> dict:
    rng = np.random.RandomState(seed)
    s = mcfg.img_size
    return {
        "image_u8": rng.randint(0, 256, (B, s, s, 3), dtype=np.uint8),
        "question": rng.randint(0, mcfg.qst_vocab_size,
                                (B, mcfg.max_qst_len)).astype(np.int32),
        "answer_label": rng.randint(0, mcfg.ans_vocab_size,
                                    (B,)).astype(np.int32),
        "answer_multi_choice": rng.randint(
            -1, mcfg.ans_vocab_size, (B, 10)).astype(np.int32),
    }


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _numpy(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


@contextlib.contextmanager
def no_randomness():
    """Dropout as the identity; torch.multinomial as the first maximum,
    so that stage 2's sampled questions are the greedy ones."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_nn, "dropout", lambda x, *a, **k: x)
        mp.setattr(torch, "multinomial",
                   lambda probs, n, generator=None: probs.argmax(
                       -1, keepdim=True))
        yield


# ---------------------------------------------------------------------------
# the steps, run by each rank on its rows and by one process on all of them
# ---------------------------------------------------------------------------

def run_steps(inputs: dict, rows: slice) -> dict:
    """Stages 1, 2 and 3 of the LCT loop and the darts family's train and
    arch steps on `rows` of the global batches, from the same weights;
    the current process group (or none) decides the sums."""
    from lctvqa_torch.models import vqa_ef
    from lctvqa_torch.optim.architect import make_darts_arch_grad
    from lctvqa_torch.optim.architect_lct import make_lct_arch_grad
    from lctvqa_torch.train.experiment_darts import make_darts_steps
    from lctvqa_torch.train.steps import make_lct_steps

    cfg = inputs["cfg"]
    tb = _tensors({k: v[rows] for k, v in inputs["train"].items()})
    vb = _tensors({k: v[rows] for k, v in inputs["valid"].items()})
    gen = torch.Generator().manual_seed(distributed.rank_seed(3))
    steps = make_lct_steps(cfg, 1, "cpu")
    ef, arch, w = inputs["ef"], inputs["arch"], inputs["w"]
    out = {}
    p, o, loss, c1, c2 = steps["stage1"](ef, arch, steps["ef_tx"].init(ef),
                                         tb, gen)
    out["stage1"] = {"params": _numpy(p), "loss": float(loss),
                     "counts": (int(c1), int(c2))}
    p, o, loss, corr = steps["stage2"](w, steps["w_tx"].init(w), ef, arch,
                                       tb, gen, gen)
    out["stage2"] = {"params": _numpy(p), "loss": float(loss),
                     "counts": (int(corr),)}
    a, ao, loss = steps["stage3"](arch, steps["arch_tx"].init(arch), ef, w,
                                  tb, vb, LR, LR, gen)
    out["stage3"] = {"arch": _numpy(a), "loss": float(loss)}
    # the arch gradient itself: Adam's first step keeps little of it but
    # its sign
    norm = {k: dict(b, image=pipeline.normalize_images(b["image_u8"]))
            for k, b in (("t", tb), ("v", vb))}
    g_a, _ = make_lct_arch_grad(cfg.model, cfg.train)(
        arch, ef, w, norm["t"], norm["v"], LR, LR, gen)
    out["stage3_grad"] = _numpy(g_a)
    darts = make_darts_steps(cfg, 1)
    p, o, loss = darts["train"](ef, darts["tx"].init(ef), arch, tb, gen)
    out["darts_train"] = {"params": _numpy(p), "loss": float(loss)}
    a, ao, loss = darts["arch"](arch, darts["arch_tx"].init(arch), ef, tb,
                                vb, LR, gen)
    out["darts_arch"] = {"arch": _numpy(a), "loss": float(loss)}
    loss_fn = (lambda p_, a_, b_, g_: vqa_ef.ef_loss(
        p_, a_, cfg.model, b_["image"], b_["question"], b_["answer_label"],
        gen=g_, deterministic=False))
    g_a, _ = make_darts_arch_grad(loss_fn, "fd")(ef, arch, norm["t"],
                                                 norm["v"], LR, gen)
    out["darts_arch_grad"] = _numpy(g_a)
    return out


def sync_batchnorm(x: np.ndarray, g: np.ndarray, rows: slice) -> dict:
    """The plain BatchNorm (differentiable, through `batch_moments`) and
    the two-launch route's plain versions (`batchnorm_fwd_stat`,
    `batchnorm_bwd`) on `rows` of x, with g the gradient of y."""
    xt = torch.from_numpy(x[rows]).requires_grad_()
    y = cuda_bn.batchnorm_plain(xt)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g[rows]))
    y2, stat, x_read = cuda_bn.batchnorm_fwd_stat(torch.from_numpy(x[rows]))
    dx2 = cuda_bn.batchnorm_bwd(x_read, torch.from_numpy(g[rows]), stat)
    return {"plain": (y.detach().numpy(), dx.numpy()),
            "two_launch": (y2.numpy(), dx2.numpy(), stat.numpy())}


def eval_runs(inputs: dict) -> dict:
    """python -m lctvqa_torch.eval at --tp 1 and 2, fp and int8, on the
    fixed-VGG EF checkpoint; and one forward's logits through the fc6/fc7
    split against the whole params."""
    from lctvqa_torch import eval as t_eval
    from lctvqa_torch.models import vqa_ef
    from lctvqa_torch.quant import quantize_model

    data = pipeline.loader_from_arrays(inputs["arrays"])
    argv = ["--exp", "fixed", "--root_stats_dir", inputs["exp_root"],
            "--input_dir", inputs["records"], "--batch_size", str(B),
            "--num_batches", "2", "--device", "cpu", "--num_show", "0"]
    out = {}
    for tp in (1, 2):
        for q in ((), ("--int8",)):
            out[(tp, bool(q))] = t_eval.main(argv + ["--tp", str(tp), *q],
                                             data=data)
    mcfg = inputs["fixed_cfg"].model
    img = torch.from_numpy(inputs["fixed_img"])
    qst = torch.from_numpy(inputs["fixed_qst"])
    grid = tp_lib.make_mesh_2d(1, WORLD)
    try:
        with torch.no_grad():
            for name, params in (("fp", inputs["fixed"]),
                                 ("int8", quantize_model(inputs["fixed"]))):
                whole = vqa_ef.ef_forward(params, None, mcfg, img, qst)[0]
                shares = tp_lib.shard_params(params, grid)
                with tp_lib.row_parallel(shares, grid):
                    split = vqa_ef.ef_forward(shares, None, mcfg, img,
                                              qst)[0]
                out[name] = (whole.numpy(), split.numpy())
    finally:
        distributed.set_data_group(None)
    return out


def one_rank_group(inputs: dict) -> dict:
    """Stage 1 on this rank's rows inside a group of this rank alone: the
    data-parallel path at one rank (what one card runs under NCCL)."""
    from lctvqa_torch.train.steps import make_lct_steps

    groups = [torch.distributed.new_group([r]) for r in range(WORLD)]
    rank = distributed.rank()
    distributed.set_data_group(groups[rank], 1, 0)
    try:
        steps = make_lct_steps(inputs["cfg"], 1, "cpu")
        rows = mesh_lib.shard_rows(B, mesh_lib.Mesh(rank, WORLD))
        tb = _tensors({k: v[rows] for k, v in inputs["train"].items()})
        ef = inputs["ef"]
        p, _, loss, _, _ = steps["stage1"](
            ef, inputs["arch"], steps["ef_tx"].init(ef), tb,
            torch.Generator().manual_seed(0))
        return {"params": _numpy(p), "loss": float(loss)}
    finally:
        distributed.set_data_group(None)


def node_kernel_steps(inputs: dict, rows: slice) -> dict:
    """Stage 1 and the darts family's train step with `pallas_mixed_op` on
    `rows` of the global batch, from the same weights as `run_steps`."""
    from lctvqa_torch.train.experiment_darts import make_darts_steps
    from lctvqa_torch.train.steps import make_lct_steps

    cfg = inputs["node_cfg"]
    tb = _tensors({k: v[rows] for k, v in inputs["train"].items()})
    gen = torch.Generator().manual_seed(distributed.rank_seed(3))
    ef, arch = inputs["ef"], inputs["arch"]
    steps = make_lct_steps(cfg, 1, "cpu")
    p, _, loss, c1, c2 = steps["stage1"](ef, arch, steps["ef_tx"].init(ef),
                                         tb, gen)
    out = {"node_stage1": {"params": _numpy(p), "loss": float(loss),
                           "counts": (int(c1), int(c2))}}
    darts = make_darts_steps(cfg, 1)
    p, _, loss = darts["train"](ef, darts["tx"].init(ef), arch, tb, gen)
    out["node_darts_train"] = {"params": _numpy(p), "loss": float(loss)}
    return out


def remat_steps(inputs: dict, rows: slice) -> dict:
    """With `remat_cells` (each cell recomputed in the backward, its
    BatchNorm and node all-reduces repeated there): stage 1, stage 1 with
    the node kernels, stage 3's arch gradient (exact-indirect: the cell
    checkpoints inside stage 3's, under create_graph) and the darts
    family's train step, on `rows` of the global batch from the same
    weights as `run_steps`."""
    from lctvqa_torch.optim.architect_lct import make_lct_arch_grad
    from lctvqa_torch.train.experiment_darts import make_darts_steps
    from lctvqa_torch.train.steps import make_lct_steps

    tb = _tensors({k: v[rows] for k, v in inputs["train"].items()})
    vb = _tensors({k: v[rows] for k, v in inputs["valid"].items()})
    gen = torch.Generator().manual_seed(distributed.rank_seed(3))
    ef, arch, w = inputs["ef"], inputs["arch"], inputs["w"]
    out = {}
    for key, cfg in (("remat_stage1", inputs["remat_cfg"]),
                     ("remat_node_stage1", inputs["remat_node_cfg"])):
        steps = make_lct_steps(cfg, 1, "cpu")
        p, _, loss, c1, c2 = steps["stage1"](ef, arch,
                                             steps["ef_tx"].init(ef), tb, gen)
        out[key] = {"params": _numpy(p), "loss": float(loss),
                    "counts": (int(c1), int(c2))}
    cfg = inputs["remat_cfg"]
    norm = {k: dict(b, image=pipeline.normalize_images(b["image_u8"]))
            for k, b in (("t", tb), ("v", vb))}
    g_a, _ = make_lct_arch_grad(cfg.model, cfg.train)(
        arch, ef, w, norm["t"], norm["v"], LR, LR, gen)
    out["remat_stage3_grad"] = _numpy(g_a)
    darts = make_darts_steps(inputs["remat_node_cfg"], 1)
    p, _, loss = darts["train"](ef, darts["tx"].init(ef), arch, tb, gen)
    out["remat_node_darts_train"] = {"params": _numpy(p),
                                     "loss": float(loss)}
    return out


def node_call(inputs: dict, rows: slice) -> dict:
    """One call of the mixed-op node (`cuda_mixedop.mixed_node`) on `rows`
    of its edge states, and its gradients for the loss sum(out * g):
    w.r.t. the rows' states, and this rank's share of those w.r.t. the
    conv weights and the mixture weights."""
    from lctvqa_torch.ops import cuda_mixedop

    node = inputs["node"]
    xs = [torch.from_numpy(x[rows]).requires_grad_() for x in node["xs"]]
    ops = tree_map(lambda v: torch.from_numpy(v).requires_grad_(),
                   node["ops"])
    wts = torch.from_numpy(node["weights"]).requires_grad_()
    out = cuda_mixedop.mixed_node(xs, ops, wts, node["cs"])
    leaves = tree_leaves(ops)
    grads = torch.autograd.grad(out, [*xs, *leaves, wts],
                                torch.from_numpy(node["g"][rows]))
    e = len(xs)
    return {"out": out.detach().numpy(),
            "dxs": [g.numpy() for g in grads[:e]],
            "params": [g.numpy() for g in grads[e:]]}


def _rank_main(rank: int, port: int, tmp: str) -> None:
    torch.set_num_threads(1)
    out_path = Path(tmp) / f"rank{rank}.pt"
    try:
        distributed.initialize(f"localhost:{port}", WORLD, rank,
                               device="cpu")
        inputs = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
        rows = mesh_lib.shard_rows(B, mesh_lib.make_mesh(WORLD))
        with no_randomness():
            out = {"steps": {**run_steps(inputs, rows),
                             **node_kernel_steps(inputs, rows),
                             **remat_steps(inputs, rows)},
                   "bn": sync_batchnorm(inputs["bn_x"], inputs["bn_g"],
                                        rows),
                   "eval": eval_runs(inputs),
                   "one_rank": one_rank_group(inputs),
                   "node": node_call(inputs, rows),
                   "rows": rows,
                   "place": (distributed.rank(), distributed.world(),
                             list(distributed.process_index_range(11)),
                             distributed.rank_seed(3))}
        torch.save(out, out_path)
    except BaseException:
        (Path(tmp) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        distributed.shutdown()


# ---------------------------------------------------------------------------
# inputs, references and the spawn
# ---------------------------------------------------------------------------

def make_inputs(tmp: Path) -> dict:
    """Every rank's inputs: seeded weights (the JAX package's stage 1
    takes them through convert), the batches, a BatchNorm input and a
    fixed-VGG EF checkpoint with its data for eval."""
    from lctvqa_torch.models import search, vqa_ef, vqa_w
    from lctvqa_torch.train import checkpoint

    cfg = config()
    init = torch.Generator().manual_seed(5)
    ef, arch = vqa_ef.init_ef_model(init, cfg.model)
    w = vqa_w.init_w_model(init, cfg.model)
    # the arch moved off its uniform mixture, so that its gradient is not
    # a symmetric one
    rng = np.random.default_rng(7)
    arch = {k: torch.from_numpy(1e-1 * rng.standard_normal(
        tuple(v.shape)).astype(np.float32)) for k, v in arch.items()}
    gen = np.random.default_rng(11)
    x = (1.5 * gen.standard_normal((B, 6, 6, 8)) + 0.3).astype(np.float32)
    g = gen.standard_normal(x.shape).astype(np.float32)
    # one node of three stride-1 edges on [B, 6, 6, 8] states, k = 4
    node_ops = [tree_map(lambda t: t.numpy(), search.mixed_op_init(
        torch.Generator().manual_seed(20 + j), 8, 1, 4)) for j in range(3)]
    mix = np.exp(gen.standard_normal((3, 8))).astype(np.float32)
    node = {"xs": [(gen.standard_normal((B, 6, 6, 8)) + 0.2).astype(
                np.float32) for _ in range(3)],
            "ops": node_ops, "cs": 2,
            "weights": mix / mix.sum(1, keepdims=True) / 3,
            "g": gen.standard_normal((B, 6, 6, 2)).astype(np.float32)}

    arrays = synthetic.make_arrays(num_images=8, num_questions=16,
                                   img_size=32)
    records = tmp / "records"
    records.mkdir()
    synthetic.make_npy_records(str(records), num_images=8, num_questions=16)
    fixed_cfg = Config(model=dataclasses.replace(
        cfg.model, arch_type="fixed", qst_vocab_size=len(arrays["qst_words"]),
        ans_vocab_size=len(arrays["ans_words"]), max_qst_len=25))
    fixed, _ = vqa_ef.init_ef_model(torch.Generator().manual_seed(2),
                                    fixed_cfg.model)
    exp = tmp / "exp" / "fixed"
    exp.mkdir(parents=True)
    checkpoint.save_state(str(exp / "ef_model.ckpt"),
                          {"ef_params": fixed, "arch": None, "epoch": 1},
                          config=fixed_cfg)
    return {"cfg": cfg, "node_cfg": config(pallas_mixed_op=True),
            "remat_cfg": config(remat_cells=True),
            "remat_node_cfg": config(remat_cells=True, pallas_mixed_op=True),
            "ef": ef,
            "arch": arch, "w": w, "node": node,
            "train": global_batch(0, cfg.model),
            "valid": global_batch(1, cfg.model),
            "bn_x": x, "bn_g": g, "arrays": arrays,
            "records": str(records), "exp_root": str(tmp / "exp"),
            "fixed_cfg": fixed_cfg, "fixed": fixed,
            "fixed_qst": rng.integers(
                0, fixed_cfg.model.qst_vocab_size,
                (B, fixed_cfg.model.max_qst_len)).astype(np.int32),
            "fixed_img": pipeline.normalize_images(
                torch.from_numpy(global_batch(0, cfg.model)["image_u8"])
            ).numpy()}


def jax_stage1(inputs: dict, key: str = "cfg") -> dict:
    """The JAX package's single-device stage 1 on the global batch, at the
    model of inputs[key], compiled with LLVM's optimizations off."""
    import jax
    import jax.numpy as jnp

    from lctvqa.config import (Config as JConfig, ModelConfig as JModel,
                               TrainConfig as JTrain)
    from lctvqa.train import steps as j_steps

    mcfg = inputs[key].model
    j_cfg = JConfig(model=JModel(**{f.name: getattr(mcfg, f.name)
                                    for f in dataclasses.fields(JModel)
                                    if hasattr(mcfg, f.name)}),
                    train=JTrain(batch_size=B))
    step = j_steps.make_lct_steps(j_cfg, unk_idx=1)
    j_arch = {k: jnp.asarray(v.numpy()) for k, v in inputs["arch"].items()}
    params = jax.tree_util.tree_map(jnp.asarray, convert.to_jax(inputs["ef"]))
    args = (params, j_arch, step["ef_tx"].init(params),
            {k: jnp.asarray(v) for k, v in inputs["train"].items()},
            jax.random.PRNGKey(0))
    fast = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
    p, _, loss, c1, c2 = step["stage1"].lower(*args).compile(fast)(*args)
    return {"params": convert.from_jax(jax.device_get(p)),
            "loss": float(loss), "counts": (int(c1), int(c2))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """-> (inputs, one process's results, the JAX stage 1, each rank's
    results). The ranks run while this process computes the
    references."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("ranks")
    inputs = make_inputs(tmp)
    torch.save(inputs, tmp / "inputs.pt")
    ctx = multiprocessing.get_context("spawn")
    port = distributed.free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        whole = slice(0, B)
        with no_randomness():
            ref = {"steps": {**run_steps(inputs, whole),
                             **node_kernel_steps(inputs, whole),
                             **remat_steps(inputs, whole)},
                   "bn": sync_batchnorm(inputs["bn_x"], inputs["bn_g"],
                                        whole),
                   "node": node_call(inputs, whole)}
        ref["jax_stage1"] = jax_stage1(inputs)
        ref["jax_node_stage1"] = jax_stage1(inputs, "node_cfg")
        for p in procs:
            p.join(JOIN_SECONDS)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        torch.set_num_threads(was)
    errors = [f.read_text() for f in sorted(tmp.glob("rank*.err"))]
    assert not errors, "\n".join(errors)
    assert [p.exitcode for p in procs] == [0] * WORLD
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return inputs, ref, outs


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _close(got, want, rtol, atol, path=""):
    """Every leaf of `got` within tolerance of `want`'s leaf of the same
    key (a tree back from the JAX package has its keys sorted)."""
    if isinstance(got, dict):
        assert set(got) == set(want), path
        for k in got:
            _close(got[k], want[k], rtol, atol, f"{path}/{k}")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, rtol, atol, f"{path}/{i}")
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=path)


def _same_bits(outs, key, tree):
    for a, b in zip(tree_leaves(outs[0]["steps"][key][tree]),
                    tree_leaves(outs[1]["steps"][key][tree])):
        assert np.array_equal(a, b), f"{key}: the ranks' {tree} differ"


def _step_matches(ranks, key, tree, atol):
    _, ref, outs = ranks
    want = ref["steps"][key]
    _same_bits(outs, key, tree)
    for out in outs:
        got = out["steps"][key]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got.get("counts") == want.get("counts")
        _close(got[tree], want[tree], 2e-4, atol)


@pytest.mark.parametrize("key,jax_key", [
    ("stage1", "jax_stage1"), ("node_stage1", "jax_node_stage1")],
    ids=["plain_ops", "node_kernels"])
def test_stage1_on_two_ranks_matches_one_process_and_jax(ranks, key,
                                                         jax_key):
    """Stage 1 (the EF update: answer and question CE, the global
    gradient clipped, Adam) on two ranks: loss, counters and parameters
    those of one process on the global batch; and those of the JAX
    package's single-device stage 1 at 1e-4. With the node kernels
    (`pallas_mixed_op`) every node's batch statistics are the global
    batch's, as on the JAX package's mesh."""
    _step_matches(ranks, key, "params", 1e-5)
    _, ref, outs = ranks
    want = ref[jax_key]
    got = outs[0]["steps"][key]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert got["counts"] == want["counts"]
    _close(got["params"], _numpy(want["params"]), 1e-4, 1e-4)


def test_stage2_on_two_ranks_matches_one_process(ranks):
    """Stage 2 (W on the real pairs and on the EF's generated ones, its
    greedy decode on each rank's rows) on two ranks."""
    _step_matches(ranks, "stage2", "params", 1e-5)


def _grads_match(ranks, key):
    """An arch gradient on each rank within 1e-4 of its leaf's scale of one
    process's (a second derivative through batch-statistics BatchNorm,
    its sums in another order), the ranks' the same bits. The normal
    cell's leaves are 0 (the one cell is a reduction cell)."""
    _, ref, outs = ranks
    for a, b in zip(tree_leaves(outs[0]["steps"][key]),
                    tree_leaves(outs[1]["steps"][key])):
        assert np.array_equal(a, b), f"{key}: the ranks differ"
    scales = []
    for got, want in zip(tree_leaves(outs[0]["steps"][key]),
                         tree_leaves(ref["steps"][key])):
        scales.append(float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= 1e-4 * scales[-1], key
    assert max(scales) > 0, key


def test_stage3_on_two_ranks_matches_one_process(ranks):
    """Stage 3 (exact-indirect, remat on): the tri-level arch gradient,
    every inner gradient summed over the ranks and differentiated again,
    the checkpointed forwards recomputed with their collectives; the step
    (the arch after Adam) and the gradient itself."""
    _step_matches(ranks, "stage3", "arch", 1e-6)
    _grads_match(ranks, "stage3_grad")


def test_darts_steps_on_two_ranks_match_one_process(ranks):
    """The darts family's train step and its arch step (the finite
    difference, exact-indirect's route in that family), and its arch
    gradient."""
    _step_matches(ranks, "darts_train", "params", 1e-5)
    _step_matches(ranks, "darts_arch", "arch", 1e-6)
    _grads_match(ranks, "darts_arch_grad")


def test_sync_batchnorm_matches_the_concatenated_batch(ranks):
    """The BatchNorm of a rank's rows with the global batch's statistics,
    forward and backward: the plain version (autograd through the
    differentiable all-reduce) and the two-launch route's plain versions,
    each rank's rows those of one process on both ranks' rows, 1e-5."""
    _, ref, outs = ranks
    y_want, dx_want = ref["bn"]["plain"]
    y1, dx1, stat1 = ref["bn"]["two_launch"]
    for out in outs:
        rows = out["rows"]
        for y, dx in (out["bn"]["plain"], out["bn"]["two_launch"][:2]):
            np.testing.assert_allclose(y, y_want[rows], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(dx, dx_want[rows], rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(out["bn"]["two_launch"][2], stat1,
                                   rtol=1e-5)


def test_eval_tp2_matches_tp1_fp_and_int8(ranks):
    """eval --tp 2 (fc6 by columns, fc7 by rows over the two ranks) against
    --tp 1 (both ranks data parallel): the same accuracy, BLEU4 and count,
    in fp and int8; one forward's logits through the split within 1e-5 of
    the whole params' in fp, and the same bits in int8 (fc7's int32 sums
    are summed before the dequantization)."""
    _, _, outs = ranks
    for out in outs:
        ev = out["eval"]
        for q in (False, True):
            assert ev[(2, q)] == ev[(1, q)], (q, ev[(2, q)], ev[(1, q)])
            assert ev[(1, q)]["n"] == 2 * B
        whole, split = ev["fp"]
        np.testing.assert_allclose(split, whole, rtol=1e-5, atol=1e-5)
        whole, split = ev["int8"]
        assert np.array_equal(split, whole)


def test_one_rank_group_takes_the_parallel_path_with_the_same_result(ranks):
    """A process group of one rank (as a card alone runs NCCL) takes the
    data-parallel path: its stage 1 equals one process's without a group
    on the same rows, 1e-5 (the two-launch statistics sum in another
    order)."""
    inputs, _, outs = ranks
    with no_randomness():
        want = run_steps_stage1_alone(inputs, outs[0]["rows"])
    got = outs[0]["one_rank"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _close(got["params"], want["params"], 2e-4, 1e-5)


def run_steps_stage1_alone(inputs, rows):
    from lctvqa_torch.train.steps import make_lct_steps

    steps = make_lct_steps(inputs["cfg"], 1, "cpu")
    tb = _tensors({k: v[rows] for k, v in inputs["train"].items()})
    ef = inputs["ef"]
    p, _, loss, _, _ = steps["stage1"](ef, inputs["arch"],
                                       steps["ef_tx"].init(ef), tb,
                                       torch.Generator().manual_seed(0))
    return {"params": _numpy(p), "loss": float(loss)}


def test_darts_train_step_with_the_node_kernels_on_two_ranks(ranks):
    """The darts family's train step with `pallas_mixed_op` on two ranks:
    loss and parameters those of one process on the global batch, the
    ranks' the same bits."""
    _step_matches(ranks, "node_darts_train", "params", 1e-5)


@pytest.mark.parametrize("key", ["remat_stage1", "remat_node_stage1",
                                 "remat_node_darts_train"])
def test_remat_cells_on_two_ranks_matches_one_process(ranks, key):
    """With `remat_cells` each cell's forward, its all-reduces included,
    runs again in the backward on every rank: stage 1 (with and without
    the node kernels) and the darts train step on two ranks are one
    process's on the global batch, the ranks' the same bits; and one
    process's remat step is its plain step, loss and parameters at the
    same tolerances."""
    _step_matches(ranks, key, "params", 1e-5)
    _, ref, _ = ranks
    plain = ref["steps"][key.replace("remat_", "")]
    got = ref["steps"][key]
    np.testing.assert_allclose(got["loss"], plain["loss"], rtol=1e-5)
    assert got.get("counts") == plain.get("counts")
    _close(got["params"], plain["params"], 2e-4, 1e-5)


def test_remat_cells_stage3_grad_on_two_ranks(ranks):
    """Stage 3's arch gradient with `remat_cells`: the cell checkpoints
    nested in the architect's under create_graph, on two ranks, within
    1e-4 of each leaf's scale of one process's, the ranks' the same
    bits; one process's within that of its plain gradient."""
    _grads_match(ranks, "remat_stage3_grad")
    _, ref, _ = ranks
    for got, want in zip(tree_leaves(ref["steps"]["remat_stage3_grad"]),
                         tree_leaves(ref["steps"]["stage3_grad"])):
        assert float(np.abs(got - want).max()) <= 1e-4 * max(
            float(np.abs(want).max()), 1e-30)


def test_node_call_on_two_ranks_matches_the_concatenated_batch(ranks):
    """One mixed-op node call on each rank's rows, its statistics summed
    over the ranks: the output and the states' gradients are one
    process's on those rows of the concatenated batch, and the ranks'
    shares of the conv and mixture weights' gradients sum to one
    process's, 1e-5."""
    _, ref, outs = ranks
    want = ref["node"]
    for out in outs:
        rows = out["rows"]
        np.testing.assert_allclose(out["node"]["out"], want["out"][rows],
                                   rtol=1e-5, atol=1e-5)
        for got, full in zip(out["node"]["dxs"], want["dxs"], strict=True):
            np.testing.assert_allclose(got, full[rows], rtol=1e-5,
                                       atol=1e-5)
    shares = [out["node"]["params"] for out in outs]
    for i, full in enumerate(want["params"]):
        np.testing.assert_allclose(shares[0][i] + shares[1][i], full,
                                   rtol=1e-5, atol=1e-5)
    assert max(float(np.abs(g).max()) for g in want["params"]) > 0


def test_each_rank_takes_its_rows_index_range_and_streams(ranks):
    """Rank r of two takes rows [4r, 4r + 4) of the global batch of 8 and
    its share of an index space (the last rank the remainder), and draws
    its dropout and sampling from its own stream, rank 0 from the seed
    itself."""
    _, _, outs = ranks
    assert [o["rows"] for o in outs] == [slice(0, 4), slice(4, 8)]
    assert [o["place"][:3] for o in outs] == [
        (0, 2, list(range(0, 5))), (1, 2, list(range(5, 11)))]
    assert outs[0]["place"][3] == 3 and outs[1]["place"][3] != 3


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    synthetic.make_dataset(str(d), num_images=8, num_questions=24)
    return str(d)


@pytest.mark.parametrize("count", [1, 2, 4])
def test_loader_rows_are_the_jax_process_slices(count, synth_dir,
                                                monkeypatch):
    """Each rank's rows of the h5 loader: epoch_batches takes the JAX
    package's process_index slices of every global batch (the same
    shuffle on every rank, the answers drawn from the rows it gathers),
    on the same directory. The JAX loader's native library is held off,
    as tests/test_torch_train_steps.py holds it, and the port's C++ core
    with it."""
    from lctvqa import native as j_native
    from lctvqa.data import pipeline as j_pipeline
    from lctvqa_torch import native

    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    ds = pipeline.get_loader(synth_dir, 8)["train"]
    j_ds = j_pipeline.VqaH5Dataset(synth_dir, "train")
    for r in range(count):
        got = pipeline.epoch_batches(ds, 8, np.random.default_rng(3),
                                     process_index=r, process_count=count)
        want = j_pipeline.epoch_batches(j_ds, 8, np.random.default_rng(3),
                                        process_index=r,
                                        process_count=count)
        for a, b in zip(got, want, strict=True):
            assert len(a["index"]) == 8 // count
            np.testing.assert_array_equal(a["index"], b["index"])
            np.testing.assert_array_equal(a["image_u8"], b["image_u8"])
            np.testing.assert_array_equal(a["answer_label"],
                                          b["answer_label"])
    with pytest.raises(AssertionError, match="divide evenly"):
        next(pipeline.epoch_batches(ds, 8, np.random.default_rng(3),
                                    process_index=0, process_count=3))


def test_npy_loader_rows_are_the_h5_loaders_rule(synth_dir):
    """The npy records' batches take the same rows of each global batch
    for every rank: together the whole window, in order."""
    ds = pipeline_npy.get_npy_loader(synth_dir, img_size=16)["train"]
    whole = [b["index"] for b in ds.batches(8, np.random.default_rng(4))]
    parts = [[b["index"] for b in ds.batches(
        8, np.random.default_rng(4), process_index=r, process_count=2)]
        for r in range(2)]
    assert len(whole) == 3
    for w, a, b in zip(whole, *parts, strict=True):
        assert len(a) == len(b) == 4
        np.testing.assert_array_equal(np.concatenate([a, b]), w)
