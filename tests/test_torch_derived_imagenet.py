"""PC-DARTS's ImageNet network as the derived EF's trunk
(`derived_skeleton="imagenet"`, lctvqa_torch/models/derived.py) against
the benchmark's plain reference of the published network
(`portbench/reference/derived.py`), on the CPU in fp32 at a size with
both kinds of cell and a normal cell after each reduction: C 8, 5 cells
(reductions at cells 1 and 3), 64-pixel images, batch 4. The JAX package
has no such skeleton: the reference is the only one compared.

Weights are the reference's seeded draw (`portbench/reference/params.py
::make`) written into the program's tree by path, which also holds the
two trees to the same leaves and shapes. Also: the published sizes at
C 48 and 14 cells, the command line that builds the configuration, the
checkpoint's config field, and an exported EF served back.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from lctvqa_torch import export
from lctvqa_torch.config import ModelConfig, small_test_config
from lctvqa_torch.models import derived, genotypes, vqa_ef
from lctvqa_torch.train import checkpoint
from lctvqa_torch.train.steps import with_grad
from portbench import flops_derived
from portbench.reference import derived as D
from portbench.reference import model as R
from portbench.reference import params as P

B = 4
# fp32 on both sides; the two differ in the order of the sums (NHWC
# against NCHW convolutions, E[x^2] - mean^2 against the centred variance
# in each of the trunk's 70 BatchNorms), which reads about 2e-6 of the
# features' norm after 5 cells
FWD_TOL = 1e-5
# the loss and its gradient add the LSTM, the heads and the backward of
# every BatchNorm, whose 1/std amplifies the forward's differences
GRAD_TOL = 1e-4
SMALL = dict(darts_init_ch=8, darts_layers=5, img_size=64)
PUBLISHED = dict(darts_init_ch=48, darts_layers=14, img_size=224)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One PyTorch intra-op thread (tests/test_torch_trace.py's)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _mcfg(**kw) -> ModelConfig:
    g = genotypes.PC_DARTS_image
    base = dataclasses.replace(
        small_test_config().model, arch_type="derived", genotype=g,
        derived_skeleton="imagenet", darts_steps=len(g.normal) // 2,
        darts_multiplier=len(g.normal_concat), compute_dtype="float32")
    return dataclasses.replace(base, **{**SMALL, **kw})


def _m(mcfg: ModelConfig) -> dict:
    """The reference's view of a configuration."""
    m = dataclasses.asdict(mcfg)
    m["genotype"] = "PC_DARTS_image"
    return m


def _params(mcfg, seed=3):
    """The reference's seeded EF tree, and the program's with its
    values."""
    want = P.make(D.ef_shapes(_m(mcfg)), seed, "cpu")
    got, _ = vqa_ef.init_ef_model(torch.Generator().manual_seed(0), mcfg)
    P.copy_into(got, want)
    return got, want


def _inputs(mcfg, seed=4):
    g = torch.Generator().manual_seed(seed)
    u8 = torch.randint(0, 256, (B, mcfg.img_size, mcfg.img_size, 3),
                       generator=g, dtype=torch.uint8)
    qst = torch.randint(0, mcfg.qst_vocab_size, (B, mcfg.max_qst_len),
                        generator=g)
    labels = torch.randint(0, mcfg.ans_vocab_size, (B,), generator=g)
    return u8, qst, labels


def _rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


def _forward_gaps(mcfg):
    """(trunk features' gap, EF answer and question logits' gaps)."""
    got, want = _params(mcfg)
    u8, qst, _ = _inputs(mcfg)
    img = R.normalize(u8)
    with torch.no_grad():
        feat = derived.derived_network_apply(
            got["derived"], mcfg, mcfg.genotype, img.permute(0, 2, 3, 1))
        ans, logits = vqa_ef.ef_forward(got, None, mcfg,
                                        img.permute(0, 2, 3, 1), qst)
        r_feat = D.network(R.EXACT, want["derived"], _m(mcfg), img)
        r_ans, r_logits = D.ef_forward(R.EXACT, want, _m(mcfg), img, qst,
                                       None)
    return (_rel(feat, r_feat), _rel(ans, r_ans), _rel(logits, r_logits))


def test_trunk_and_ef_logits_match_the_reference():
    assert max(_forward_gaps(_mcfg())) < FWD_TOL


def test_stage1_loss_and_every_gradient_match_the_reference():
    """Stage 1's loss (answer CE + shifted teacher forcing) and each leaf's
    gradient, dropout off on both sides."""
    mcfg = dataclasses.replace(_mcfg(), dropout_rate=0.0)
    got, want = _params(mcfg)
    u8, qst, labels = _inputs(mcfg)
    img = R.normalize(u8)
    p = with_grad(got)
    ans, logits = vqa_ef.ef_forward(p, None, mcfg, img.permute(0, 2, 3, 1),
                                    qst)
    v = logits.shape[-1]
    loss = (R.cross_entropy(ans, labels)
            + R.cross_entropy(logits[:, :-1].reshape(-1, v),
                              qst[:, 1:].reshape(-1)))
    leaves = P.flat(p)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    opt = R.Adam(want, 0.0, 5.0)
    _, r_loss, r_grads = D.stage1(R.EXACT, want, _m(mcfg), opt, img, qst,
                                  labels, None)
    assert abs(float(loss.detach()) - r_loss) <= GRAD_TOL * abs(r_loss)
    # the reference's gradients come back clipped to norm 5, in the order
    # of its leaves' names
    norm = math.sqrt(sum(float(g.double().square().sum())
                         for g in grads.values()))
    scale = 5.0 / max(norm, 5.0)
    names = R.leaf_names(want)
    assert sorted(names) == sorted(grads) and len(r_grads) == len(names)
    for name, r in zip(names, r_grads):
        assert float((grads[name] * scale - r).norm()) <= GRAD_TOL * max(
            float(r.norm()), 1e-6), name


def test_the_pools_bn_put_back_fails_the_comparison(monkeypatch):
    """The control: the reference with the search network's BN after each
    pool is not the program's network."""
    plain = D.op

    def pool_bn(q, name, p, x, stride):
        y = plain(q, name, p, x, stride)
        return R.bn(y) if name.endswith("pool_3x3") else y

    monkeypatch.setattr(D, "op", pool_bn)
    assert max(_forward_gaps(_mcfg())) > 100 * FWD_TOL


def test_the_published_sizes():
    """4.57 M parameters in the trunk by the reference's layer list (5.34
    M with the published 1,000-way classifier; the paper gives 5.3 M),
    the program's tree the same, and the trunk's multiply-adds at 224 px
    within 5% of the paper's 597 M less the classifier's."""
    mcfg = _mcfg(**PUBLISHED)
    shapes = D.network_shapes(_m(mcfg))
    n = sum(math.prod(s) for s in P.flat(shapes).values())
    assert n == 4_573_464
    classifier = 768 * 1000 + 1000
    assert round((n + classifier) / 1e6, 1) == 5.3
    tree = derived.derived_network_init(torch.Generator(), mcfg,
                                        mcfg.genotype)
    got = {k: tuple(v.shape) for k, v in P.flat(tree).items()}
    assert got == P.flat(shapes)
    assert derived.derived_out_features(mcfg, mcfg.genotype) == 768 * 49
    macs = flops_derived.trunk_fwd_flops(_m(mcfg), 1) / 2
    assert macs == pytest.approx(597e6 - 768 * 1000, rel=0.05)


def test_the_command_line_builds_the_configuration():
    from lctvqa_torch import main
    args = main.build_parser().parse_args([
        "--arch_type", "derived", "--genotype", "PC_DARTS_image",
        "--derived_skeleton", "imagenet", "--darts_init_ch", "48",
        "--darts_layers", "14", "--img_size", "224"])
    m = main.config_from_args(args).model
    assert m.genotype == genotypes.PC_DARTS_image
    assert (m.arch_type, m.derived_skeleton) == ("derived", "imagenet")
    assert (m.darts_init_ch, m.darts_layers, m.img_size) == (48, 14, 224)
    assert (m.darts_steps, m.darts_multiplier) == (4, 4)
    plain = main.config_from_args(main.build_parser().parse_args([]))
    assert plain.model == ModelConfig(
        img_size=64, pallas_generate=plain.model.pallas_generate,
        pallas_seq_lstm=plain.model.pallas_seq_lstm)


@pytest.mark.parametrize("skeleton", ["search", "imagenet"])
def test_the_checkpoint_writes_the_skeleton_only_off_its_default(
        skeleton, tmp_path):
    """A field the JAX package lacks is left out at its default, so that
    package still reads the port's other checkpoints."""
    cfg = small_test_config()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, derived_skeleton=skeleton))
    path = str(tmp_path / "c.ckpt")
    checkpoint.save_state(path, {"epoch": 1}, cfg)
    state = checkpoint.load_state(path)
    assert ("derived_skeleton" in state["config"]["model"]) == (
        skeleton != "search")
    assert checkpoint.config_from_state(state).model.derived_skeleton == \
        skeleton


def test_an_exported_ef_serves_as_the_eager_call(tmp_path):
    """export_state and save_artifact of the EF, loaded back by
    load_artifact with its genotype: the skeleton told from the tree,
    `generate` and `answer_logits` equal to the eager calls; a genotype
    of another network raises."""
    mcfg = _mcfg(max_qst_len=6)
    got, _ = _params(mcfg)
    u8, qst, _ = _inputs(mcfg)
    path = str(tmp_path / "ef.lctx")
    export.save_artifact(export.export_state({"ef_params": got}, mcfg),
                         path)
    model = export.load_artifact(path, device="cpu",
                                 genotype="PC_DARTS_image",
                                 compute_dtype="float32")
    c = model.config
    assert (c.derived_skeleton, c.darts_init_ch, c.darts_layers) == (
        "imagenet", 8, 5)
    with torch.no_grad():
        tok, ans = export.generate("ef", mcfg, got, None, u8)
        logits = export.answer_logits("ef", mcfg, got, None, u8, qst)
    s_tok, s_ans = model.generate(u8.numpy())
    np.testing.assert_array_equal(s_tok.numpy(), tok.numpy())
    np.testing.assert_array_equal(s_ans.numpy(), ans.numpy())
    np.testing.assert_array_equal(
        model.answer_logits(u8.numpy(), qst.numpy().astype(np.int32))
        .numpy(), logits.numpy())
    with pytest.raises(ValueError, match="builds another network"):
        export.load_artifact(path, device="cpu", genotype="PC_DARTS_cifar")
