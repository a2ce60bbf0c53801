"""Closed-loop LCT training with a derived EF: PC-DARTS's ImageNet network
(`reference/derived.py`) as the EF's image encoder, retrained through the
port's `Experiment.train_step` (stage 1, then stage 2; a derived EF has
no arch and no stage 3), on batches that the port's Prefetcher brings
from a seeded split in host RAM.

It is `train.py`'s driver with the derived EF: the same set-up, checked
steps, faults and window, against this network's reference. The numbers
compared are `train.compare`'s but for `loss_gap`, and `cell_gap`: the
widest of the one-stage gaps of the program's first trunk forward (the
seeded weights, the first checked batch), each stage of the exact
reference run alone on the program's own input to it (stem0 on the
image, stem1 on the program's stem0, cell k on the program's two states
before it, the features on its last cell), so that rounding does not
compound from cell to cell. The trunk at its seeded weights is chaotic:
a rounding of its operands grows from cell to cell until the features
decorrelate, so that the first gradient, the losses and the change after
three steps read alike at bf16 and fp8 (`PERF.md` §4), while each
stage's own gap reads the rounding itself. `control()` gives the fp8
control's numbers. Besides, each call of the trunk's forward
(`models/derived.py::derived_network_apply`) runs in a marked harness
span `trunk`, and the window's result carries the program's span and
count table (`lctvqa_torch.trace.TABLE`, reset as the window starts)
under "program", and the model FLOPs of `flops_derived.py`.

A program without the configuration's `derived_skeleton` cannot run the
cell: importing this driver then raises a KeyError, which `run` refuses
(exit 2).
"""

from __future__ import annotations

import dataclasses
import sys
import tempfile

import torch

from portbench import flops_derived, generate
from portbench.drivers import train
from portbench.reference import derived as D
from portbench.reference import model as R
from portbench.reference import params as P

NUMBERS = ("cell_gap", "grad_gap_median", "change_gap", "sample_gap")

def _program_has_the_skeleton() -> bool:
    from lctvqa_torch.config import ModelConfig
    return "derived_skeleton" in {f.name for f in
                                  dataclasses.fields(ModelConfig)}


if not _program_has_the_skeleton():
    # a key of the configuration that the program does not know: `run`
    # refuses a KeyError as a malformed file (exit 2)
    raise KeyError("the program's ModelConfig has no derived_skeleton: it "
                   "cannot build this cell's network")


class Driver(train.Driver):

    def _values(self, device):
        sd = self._seeds()
        return (P.make(D.ef_shapes(self.m), sd["ef"], device), None,
                P.make(P.w_shapes(self.m), sd["w"], device))

    def _model_config(self):
        from lctvqa_torch.config import ModelConfig
        from lctvqa_torch.genotype import resolve_genotype
        return ModelConfig(**{**self.m, "genotype": resolve_genotype(
            self.m["genotype"])})

    def setup(self) -> None:
        from lctvqa_torch.config import Config, DataConfig, TrainConfig
        from lctvqa_torch.data import pipeline
        from lctvqa_torch.models import vqa_ef
        from lctvqa_torch.ops import conv
        from lctvqa_torch.optim.optimizers import tree_map
        from lctvqa_torch.train.experiment import Experiment

        ctx = self.ctx
        conv.USE_PALLAS_BN = bool(ctx.config.get("bn_kernel", False))
        dev = ctx.device
        self.arrays = generate.qa_set(ctx.seed, ctx.mix, self.m)
        ef, _, w = self._values(dev)
        self._tmp = tempfile.TemporaryDirectory(prefix="portbench-")
        cfg = Config(model=self._model_config(),
                     train=TrainConfig(**self.t,
                                       seed=self._seeds()["program"]),
                     data=DataConfig(**ctx.config.get("data", {})),
                     root_stats_dir=self._tmp.name, exp_name="run")
        exp = Experiment(cfg, dev.type if dev.type == "cpu" else dev,
                         data=pipeline.loader_from_arrays(self.arrays),
                         vgg_params=w["vgg"])
        P.copy_into(exp.ef_params, ef)
        P.copy_into(exp.w_params, w)
        self.exp = exp
        self._tracer = None
        self._wrap_stages()
        self.features, self.states = None, []
        self._wrap_trunk()
        self._feed = self._new_feed()

        # the checked steps, through the window's own call and feed
        original = vqa_ef.ef_generate
        self.pseudo = []

        def recording(*a, **k):
            qst, ans = original(*a, **k)
            if self.fault == "token":
                qst = ((qst.long() + 1) % self.m["qst_vocab_size"]).to(
                    qst.dtype)
            self.pseudo.append(qst.detach().clone())
            return qst, ans

        vqa_ef.ef_generate = recording
        self.batches, self.losses = [], []
        try:
            for k in range(train.CHECKED_STEPS):
                batch = self._next()
                self.batches.append({key: batch[key].clone() for key in
                                     ("image_u8", "question",
                                      "answer_label")})
                out = exp.train_step(batch)
                self.losses.append((out[0], out[3]))
                if k == 0:
                    first = {"ef": tree_map(lambda v: v / (1 - train.B1),
                                            exp.ef_opt["m"]),
                             "w": tree_map(lambda v: v / (1 - train.B1),
                                           exp.w_opt["m"])}
                    self.grad_norms = {n: train.norms(t)
                                       for n, t in first.items()}
                    del first
        finally:
            vqa_ef.ef_generate = original
        self.change_norms = {"ef": train.diff_norms(exp.ef_params, ef),
                             "w": train.diff_norms(train._no_vgg(
                                 exp.w_params), train._no_vgg(w))}
        self.losses = [(float(a), float(b)) for a, b in self.losses]
        del ef, w
        for _ in range(train.WARM_STEPS):
            exp.train_step(self._next())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _wrap_trunk(self):
        """The trunk's forward in a marked harness span `trunk` while a
        window runs; the first forward's stems, cell outputs and features
        kept, NCHW in float32."""
        from lctvqa_torch.models import derived
        fn = self._trunk_fn = derived.derived_network_apply
        cell_fn = self._cell_fn = derived.derived_cell_apply

        def nchw(t):
            return t.detach().float().permute(0, 3, 1, 2).clone()

        def cell(p, s0, s1, *a, **k):
            out = cell_fn(p, s0, s1, *a, **k)
            if self.features is None and self._tracer is None:
                if not self.states:
                    # cell 0's inputs: stem0's and stem1's outputs
                    self.states += [nchw(s0), nchw(s1)]
                self.states.append(nchw(out))
            return out

        def wrapped(*a, **k):
            if self._tracer is None:
                out = fn(*a, **k)
                if self.features is None:
                    # the first checked step's: the seeded weights
                    self.features = out.detach().float().clone()
                return out
            with self._tracer.span("trunk", mark=True):
                return fn(*a, **k)

        derived.derived_network_apply = wrapped
        derived.derived_cell_apply = cell

    def window(self, seconds: float, tracer) -> dict:
        from lctvqa_torch import trace
        trace.TABLE.reset()
        out = super().window(seconds, tracer)
        out["program"] = {"totals": dict(trace.TABLE.totals),
                          "counts": dict(trace.TABLE.counts)}
        out["flops"] = out["units"] * flops_derived.lct_train_step(self.m,
                                                                   self.b)
        return out

    def release(self) -> None:
        from lctvqa_torch.models import derived
        if hasattr(self, "_trunk_fn"):
            derived.derived_network_apply = self._trunk_fn
            derived.derived_cell_apply = self._cell_fn
        super().release()

    def program_readings(self) -> dict:
        return {**super().program_readings(), "features": self.features,
                "states": self.states}

    def check(self) -> dict:
        want = (len(self.batches[0]["question"]), self.m["max_qst_len"])
        if any(tuple(t.shape) != want for t in self.pseudo):
            return dict.fromkeys(NUMBERS, float("inf"))
        return numbers(self.program_readings(), self.reference(R.EXACT),
                       *self._first_forward())

    def control(self) -> dict:
        """The numbers of the reference with fp8 operands in the
        program's place."""
        ctl = self.reference(R.Numerics("fp8"))
        return numbers(ctl, self.reference(R.EXACT, pseudo=ctl["pseudo"]),
                       *self._first_forward())

    def _first_forward(self):
        """The seeded trunk's weights, the configuration, and the first
        checked batch's image NCHW: what the first trunk forward ran on."""
        ef = P.make(D.ef_shapes(self.m), self._seeds()["ef"], self.ctx.device)
        return ef["derived"], self.m, R.normalize(self.batches[0]["image_u8"])

    def reference(self, q, pseudo=None) -> dict:
        """`train.Driver.reference` with this network's EF: the same
        steps, batches, dropout stream and questions."""
        dev = self.ctx.device
        m, t = self.m, self.t
        ef, _, w = self._values(dev)
        ef0, w0 = ef, train._no_vgg(w)
        gen = torch.Generator(device=dev).manual_seed(
            self._seeds()["program"])
        sgen = torch.Generator(device=dev).manual_seed(
            generate.stream(self.ctx.seed, 4))
        ef_opt = R.Adam(ef, t["learning_rate"], t["grad_clip"])
        w_opt = R.Adam(w, t["learning_rate"], t["grad_clip"])
        out = {"losses": [], "pseudo": [], "logp": []}
        with R.exact_matmuls():
            for k, bt in enumerate(self.batches):
                img = R.normalize(bt["image_u8"])
                qst, lab = bt["question"], bt["answer_label"]
                if k == 0 and q is not R.EXACT:
                    # the control's first forward, read as the program's
                    out["states"] = []
                    with torch.no_grad():
                        out["features"] = D.network(q, ef["derived"], m, img,
                                                    out["states"])
                ef, l1, g1 = D.stage1(q, ef, m, ef_opt, img, qst, lab, gen)
                with torch.no_grad():
                    feat = D.ef_image(q, ef, m, img)
                    if pseudo is not None:
                        ps = pseudo[k]
                    elif q is R.EXACT:
                        ps = self.pseudo[k]
                    else:
                        ps = R.sample_tokens(q, ef, feat, m["max_qst_len"],
                                             t["temperature"], sgen)
                    if q is R.EXACT:
                        out["logp"].append(torch.log_softmax(
                            R.decode_logits(q, ef, feat, ps)
                            / t["temperature"], -1))
                w, l2, g2 = R.stage2(q, w, ef, None, m, w_opt, img, qst, lab,
                                     ps, gen, t["w_lambda"], img_feat=feat)
                out["losses"].append((l1, l2))
                out["pseudo"].append(ps)
                if k == 0:
                    out["grads"] = {
                        name: {path: float(torch.linalg.vector_norm(g))
                               for path, g in zip(P.flat(tree), gs)}
                        for name, tree, gs in (("ef", ef, g1), ("w", w, g2))}
        out["changes"] = {"ef": train.diff_norms(ef, ef0),
                          "w": train.diff_norms(train._no_vgg(w), w0)}
        return out


def _gap(got, want) -> float:
    """|got - want| / |want|; inf where `got` is missing, of another shape
    (not the whole batch's) or not finite."""
    if got is None or got.shape != want.shape:
        return float("inf")
    gap = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    return gap if gap == gap else float("inf")


def trunk_gaps(got: dict, trunk: dict, m: dict, img) -> list:
    """`_gap` of each stage of the first trunk forward in `got` (its
    "states": stem0's, stem1's and each cell's output; its "features")
    from the exact reference's same stage run on `got`'s own input to it:
    stem0 on the image, stem1 on `got`'s stem0, cell k on `got`'s two
    states before it, the features on its last cell."""
    states, n = got["states"], m["darts_layers"]
    if len(states) != n + 2 or got["features"] is None:
        return [float("inf")]
    with torch.no_grad(), R.exact_matmuls():
        gaps = [_gap(states[0], D.stem0(R.EXACT, trunk, img)),
                _gap(states[1], D.stem1(R.EXACT, trunk, states[0]))]
        for k in range(n):
            gaps.append(_gap(states[k + 2], D.cell_at(
                R.EXACT, trunk, m, k, states[k], states[k + 1])))
        gaps.append(_gap(got["features"], D.head(states[-1])))
    return gaps


def numbers(got: dict, want: dict, trunk: dict, m: dict, img) -> dict:
    """`train.compare`'s numbers but for `loss_gap`, and `cell_gap`, the
    widest of `trunk_gaps` (each printed on standard error: stem0, stem1,
    the cells, the features)."""
    out = train.compare(got, want)
    del out["loss_gap"]
    gaps = trunk_gaps(got, trunk, m, img)
    print("portbench: trunk gaps " + " ".join(f"{g:.3g}" for g in gaps),
          file=sys.stderr)
    out["cell_gap"] = max(gaps)
    return {k: out[k] for k in NUMBERS}
