"""Closed-loop question generation: batches of host uint8 images to the
port's `ServingModel.generate` of a darts EF artifact (the PC-DARTS
supernet, greedy decode, the answer head), `ahead` calls dispatched
before the oldest result is read back.

The check runs the plain reference in float32 on a seeded sample of the
window's calls: the supernet on the same batch (its BatchNorm takes the
batch's statistics), then the decoder fed the served tokens; it reads the
widest gap by which a served token's logit lies below the reference's
best at its position, and the same of the served answer.
"""

from __future__ import annotations

import torch

from portbench import flops, generate
from portbench.drivers import serving as S
from portbench.reference import model as R

SAMPLED_CALLS = 4


class Driver:
    unit = "call"
    e2e = "generated_qst_s"

    def __init__(self, ctx):
        self.ctx = ctx
        self.m = ctx.config["model"]
        self.mix = ctx.mix
        self.fault = ctx.fault

    def setup(self) -> None:
        ctx = self.ctx
        self.batches = [{"image_u8": b["image_u8"]} for b in
                        generate.answer_batches(ctx.seed, self.mix, self.m)]
        self.model = S.serving_model(ctx.config, "ef", ctx.seed, ctx.device)
        for b in self.batches[:2]:
            tuple(o.cpu() for o in self._call(b))
        self.sample = S.Reservoir(ctx.seed, SAMPLED_CALLS)

    def _call(self, b):
        qst, ans = self.model.generate(b["image_u8"])
        if self.fault == "token":
            qst = (qst.long() + 1) % self.m["qst_vocab_size"]
        return qst, ans

    def window(self, seconds: float, tracer) -> dict:
        r = S.closed_loop(self._call, self.batches, seconds,
                          self.mix["ahead"], tracer, self.sample,
                          self.mix["batch"], self.ctx.device, "generate")
        return {"seconds": r["seconds"], "attempted": r["done"] + r["failed"],
                "failed": r["failed"],
                "values": {"generated_qst_s": r["done"] / r["seconds"]},
                "units": r["calls"],
                "flops": r["calls"] * flops.ef_generate_flops(
                    self.m, self.mix["batch"])}

    def release(self) -> None:
        self.model = None
        S.release(self.ctx.device)

    def _reference(self):
        vals = S.family_values("ef", self.m, self.ctx.seed, self.ctx.device)
        return vals["ef_params"], vals["arch"]

    @torch.no_grad()
    def outputs(self, tokens, u8, ef, arch, q=R.EXACT):
        """The reference's decoder logits fed the served tokens [B, T, V]
        and its answer logits to them [B, A], for one batch."""
        dev = self.ctx.device
        with R.exact_matmuls():
            img = R.normalize(torch.as_tensor(u8, device=dev))
            feat = R.ef_image(q, ef, arch, self.m, img)
            toks = torch.as_tensor(tokens, device=dev).long()
            qf, _ = R.ef_encode(q, ef, feat, toks)
            return (R.decode_logits(q, ef, feat, toks),
                    R.answer_head(q, ef, feat, qf, 0.0, None))

    def _sampled(self, pick):
        """The widest gaps over the sampled calls of the exact reference's
        best logit over its logit at the tokens and answers `pick(tokens,
        answers, u8, ef, arch)` names."""
        ef, arch = self._reference()
        tok = ans = 0.0
        for i, (tokens, answers) in self.sample.items:
            u8 = self.batches[i]["image_u8"]
            logits, ref_ans = self.outputs(tokens, u8, ef, arch)
            t, a = pick(tokens, answers, u8, ef, arch)
            dev = logits.device
            tok = max(tok, _gap(logits, torch.as_tensor(t, device=dev)))
            ans = max(ans, _gap(ref_ans, torch.as_tensor(a, device=dev)))
        return {"token_gap": tok, "answer_gap": ans}

    def check(self) -> dict:
        return self._sampled(lambda tokens, answers, *_: (tokens, answers))

    def control(self) -> dict:
        """The gaps at the tokens and answers that the reference with
        float8 operands puts first, fed the served tokens."""
        low = R.Numerics("fp8")

        def first(tokens, answers, u8, ef, arch):
            logits, ans = self.outputs(tokens, u8, ef, arch, low)
            return logits.argmax(-1), ans.argmax(-1)

        return self._sampled(first)


def _gap(logits: torch.Tensor, idx: torch.Tensor) -> float:
    """max over positions of (the best logit - the logit at idx)."""
    at = logits.gather(-1, idx.long()[..., None])[..., 0]
    return float((logits.amax(-1) - at).max())
