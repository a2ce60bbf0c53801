"""Closed-loop LCT training (the port's `Experiment.train_step`: stage 1,
then stage 2) on batches that the port's own Prefetcher brings from a
seeded split in host RAM.

Set-up builds the Experiment once, writes the seeded weights into its
trees, and drives its first `CHECKED_STEPS` steps through the window's
own call and feed; it records what the check needs of them (the losses,
the first gradient as the optimizer's state holds it, each leaf's change
after the last, the batches and the EF's sampled questions), takes
`WARM_STEPS` more, and hands the same object to the window. The check
runs the plain reference through the same steps from the same weights,
batches and dropout stream, on the program's sampled questions, and
judges those questions by the reference's probabilities.
"""

from __future__ import annotations

import gc
import sys
import tempfile
import time

import torch

from portbench import flops, generate
from portbench.reference import model as R
from portbench.reference import params as P

NUMBERS = ("loss_gap", "grad_gap_median", "change_gap", "sample_gap")
CHECKED_STEPS = 3
WARM_STEPS = 2
B1 = 0.9


def norms(tree) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in P.flat(tree).items()}


def diff_norms(a, b) -> dict:
    fb = P.flat(b)
    return {k: float(torch.linalg.vector_norm(v.float() - fb[k].float()))
            for k, v in P.flat(a).items()}


def moved_leaves(grads: dict) -> set:
    """The leaves the reference moves: a first gradient that is not
    nought to rounding, that is, at least a thousandth of the median
    non-zero leaf's norm (a key's bias under softmax moves under Adam by
    round-off alone; the frozen trunk gets none)."""
    vals = sorted(v for v in grads.values() if v > 0)
    if not vals:
        return set()
    med = vals[len(vals) // 2]
    return {k for k, v in grads.items() if v >= 1e-3 * med}


def leaf_gaps(got: dict, want: dict, keep: set) -> dict:
    """Each kept leaf's |got - want| / max(want, the median kept leaf's
    want), where `got` and `want` are its norms; a non-finite norm reads
    inf."""
    vals = sorted(want[k] for k in keep)
    med = vals[len(vals) // 2]
    out = {}
    for k in keep:
        g, w = got[k], want[k]
        finite = g == g and abs(g) != float("inf")
        out[k] = abs(g - w) / max(w, med) if finite else float("inf")
    return out


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


def gap_of_norms(got: dict, want: dict, keep: set, what: str = "") -> float:
    """The widest of `leaf_gaps`; the widest few are printed on standard
    error, with their norms."""
    gaps = leaf_gaps(got, want, keep)
    worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
    if what:
        print(f"portbench: {what} widest leaves: " + "; ".join(
            f"{k} {gaps[k]:.4g} (got {got[k]:.4g}, want {want[k]:.4g})"
            for k in worst), file=sys.stderr)
    return max(gaps.values()) if gaps else 0.0


class Driver:
    unit = "step"
    e2e = "train_pairs_s"

    def __init__(self, ctx):
        self.ctx = ctx
        self.m = ctx.config["model"]
        self.t = ctx.config["train"]
        self.b = self.t["batch_size"]
        self.fault = ctx.fault

    # --------------------------------------------------------------- set-up
    def _seeds(self):
        s = self.ctx.seed
        return {"ef": generate.stream(s, 1), "arch": generate.stream(s, 2),
                "w": generate.stream(s, 3), "program": s % (2 ** 62)}

    def _values(self, device):
        sd = self._seeds()
        return (P.make(P.ef_shapes(self.m), sd["ef"], device),
                P.make(P.arch_shapes(self.m), sd["arch"], device),
                P.make(P.w_shapes(self.m), sd["w"], device))

    def setup(self) -> None:
        from lctvqa_torch.config import (Config, DataConfig, ModelConfig,
                                         TrainConfig)
        from lctvqa_torch.data import pipeline
        from lctvqa_torch.ops import conv
        from lctvqa_torch.train.experiment import Experiment

        ctx = self.ctx
        conv.USE_PALLAS_BN = bool(ctx.config.get("bn_kernel", False))
        dev = ctx.device
        self.arrays = generate.qa_set(ctx.seed, ctx.mix, self.m)
        ef, arch, w = self._values(dev)
        self._tmp = tempfile.TemporaryDirectory(prefix="portbench-")
        cfg = Config(model=ModelConfig(**self.m),
                     train=TrainConfig(**self.t,
                                       seed=self._seeds()["program"]),
                     data=DataConfig(**ctx.config.get("data", {})),
                     root_stats_dir=self._tmp.name, exp_name="run")
        exp = Experiment(cfg, dev.type if dev.type == "cpu" else dev,
                         data=pipeline.loader_from_arrays(self.arrays),
                         vgg_params=w["vgg"])
        P.copy_into(exp.ef_params, ef)
        P.copy_into(exp.arch, arch)
        P.copy_into(exp.w_params, w)
        self.exp = exp
        self._tracer = None
        self._wrap_stages()
        self._feed = self._new_feed()

        # the checked steps, through the window's own call and feed
        from lctvqa_torch.models import vqa_ef
        from lctvqa_torch.optim.optimizers import tree_map
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
            for k in range(CHECKED_STEPS):
                batch = self._next()
                self.batches.append({key: batch[key].clone() for key in
                                     ("image_u8", "question",
                                      "answer_label")})
                out = exp.train_step(batch)
                self.losses.append((out[0], out[3]))
                if k == 0:
                    first = {"ef": tree_map(lambda v: v / (1 - B1),
                                            exp.ef_opt["m"]),
                             "w": tree_map(lambda v: v / (1 - B1),
                                           exp.w_opt["m"])}
                    self.grad_norms = {n: norms(t) for n, t in first.items()}
                    del first
        finally:
            vqa_ef.ef_generate = original
        self.change_norms = {"ef": diff_norms(exp.ef_params, ef),
                             "w": diff_norms(_no_vgg(exp.w_params),
                                             _no_vgg(w))}
        self.losses = [(float(a), float(b)) for a, b in self.losses]
        del ef, arch, w
        for _ in range(WARM_STEPS):
            exp.train_step(self._next())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _wrap_stages(self):
        steps = self.exp.steps
        for name in ("stage1", "stage2"):
            fn = steps[name]

            def wrapped(*a, _fn=fn, _name=name):
                if self.fault == "frozen":
                    # the step's state handed back unchanged
                    out = _fn(*a)
                    state = (a[0], a[1] if _name == "stage2" else a[2])
                    return (*state, *out[2:])
                if self.fault == "half_batch" and _name == "stage1":
                    # the EF's loss the mean over half of the batch
                    half = {k: v[: v.shape[0] // 2] for k, v in
                            a[3].items()}
                    a = a[:3] + (half,) + a[4:]
                if self._tracer is None:
                    return _fn(*a)
                with self._tracer.span(_name, mark=True):
                    return _fn(*a)

            steps[name] = wrapped

    def _new_feed(self):
        from lctvqa_torch.data import pipeline
        exp = self.exp
        return pipeline.Prefetcher(exp._epoch_iter("train"), exp.device,
                                   depth=exp.cfg.data.prefetch)

    def _next(self):
        try:
            return next(self._feed)
        except StopIteration:
            self._feed = self._new_feed()
            return next(self._feed)

    # --------------------------------------------------------------- window
    def window(self, seconds: float, tracer) -> dict:
        self._tracer = tracer
        dev = self.ctx.device
        exp = self.exp
        losses = []
        steps = 0
        t0 = time.perf_counter()
        while True:
            with tracer.span("prefetch_next"):
                batch = self._next()
            with tracer.span("train_step"):
                out = exp.train_step(batch)
            losses.append(torch.stack([out[0], out[3]]))
            steps += 1
            tracer.tick()
            if time.perf_counter() - t0 >= seconds and not tracer.pending:
                break
        tracer.close()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
        read = torch.stack(losses).cpu()
        failed = int((~torch.isfinite(read)).any(1).sum())
        self._tracer = None
        return {"seconds": elapsed, "attempted": steps, "failed": failed,
                "values": {"train_pairs_s": (steps - failed) * self.b
                           / elapsed},
                "units": steps, "flops": steps * flops.lct_train_step(
                    self.m, self.b)}

    def release(self) -> None:
        self.exp = self._feed = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        self._tmp.cleanup()

    # ---------------------------------------------------------------- check
    def program_readings(self) -> dict:
        return {"losses": self.losses, "grads": self.grad_norms,
                "changes": self.change_norms, "pseudo": self.pseudo}

    def check(self) -> dict:
        """The program's readings against the plain reference's run of
        the same steps -> the numbers compared."""
        want = (len(self.batches[0]["question"]), self.m["max_qst_len"])
        if any(tuple(t.shape) != want for t in self.pseudo):
            # questions that are not one a row of the batch: no reading
            return dict.fromkeys(NUMBERS, float("inf"))
        return compare(self.program_readings(), self.reference(R.EXACT))

    def reference(self, q, pseudo=None) -> dict:
        """The plain reference's run of the checked steps, the products'
        operands rounded by `q`, W trained on `pseudo` (each step's
        questions; default: the program's where `q` is exact, else a draw
        of its own at the training temperature, on a generator of its
        own). The log-probabilities it returns are the exact decoder's
        read at the questions W trains on."""
        dev = self.ctx.device
        m, t = self.m, self.t
        ef, arch, w = self._values(dev)
        ef0, w0 = ef, _no_vgg(w)
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
                ef, l1, g1 = R.stage1(q, ef, arch, m, ef_opt, img, qst, lab,
                                      gen)
                with torch.no_grad():
                    feat = R.ef_image(q, ef, arch, m, img)
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
                w, l2, g2 = R.stage2(q, w, ef, arch, m, w_opt, img, qst, lab,
                                     ps, gen, t["w_lambda"], img_feat=feat)
                out["losses"].append((l1, l2))
                out["pseudo"].append(ps)
                if k == 0:
                    out["grads"] = {
                        name: {path: float(torch.linalg.vector_norm(g))
                               for path, g in zip(P.flat(tree), gs)}
                        for name, tree, gs in (("ef", ef, g1), ("w", w, g2))}
        out["changes"] = {"ef": diff_norms(ef, ef0),
                          "w": diff_norms(_no_vgg(w), w0)}
        return out


def _no_vgg(tree: dict) -> dict:
    return {k: v for k, v in tree.items() if k != "vgg"}


def compare(got: dict, want: dict) -> dict:
    """The numbers compared: the widest relative gap of a step's loss, of
    a moved leaf's first-gradient norm, of a moved leaf's change after the
    checked steps, and the gap in nats between the mean log-probability
    that the reference gives the sampled questions' tokens and the one it
    expects of a draw from itself (`want["logp"]` read at `got`'s
    questions)."""
    loss = max(abs(g - w) / abs(w) if abs(w) > 0 else abs(g)
               for gs, ws in zip(got["losses"], want["losses"])
               for g, w in zip(gs, ws))
    if loss != loss:
        loss = float("inf")
    sample = 0.0
    for toks, lp in zip(got["pseudo"], want["logp"]):
        taken = lp.gather(-1, toks.long()[..., None])[..., 0].mean()
        expect = (lp.exp() * lp).sum(-1).mean()
        sample = max(sample, abs(float(expect - taken)))
    keep = {n: moved_leaves(want["grads"][n]) for n in ("ef", "w")}
    # the first gradient's widest leaf reads 0.1-0.25 on every seed, and
    # so does the plain reference in bfloat16 against itself in float32
    # (cell 0's pointwise weights, under BatchNorm over 3.2 M rows): it is
    # printed, and the median leaf's gap, steady from seed to seed, is
    # compared
    for n in ("ef", "w"):
        gap_of_norms(got["grads"][n], want["grads"][n], keep[n],
                     f"{n} first gradient")
    return {"loss_gap": loss,
            "grad_gap_median": max(_median(leaf_gaps(
                got["grads"][n], want["grads"][n], keep[n]).values())
                for n in ("ef", "w")),
            "change_gap": max(gap_of_norms(got["changes"][n],
                                           want["changes"][n],
                                           keep[n] & set(want["changes"][n]),
                                           f"{n} change")
                              for n in ("ef", "w")),
            "sample_gap": sample}
