"""Closed-loop batch answering: batches of host uint8 images and int32
questions to the port's `ServingModel.answer_logits`, `ahead` calls
dispatched before the oldest result is read back.

The check runs the plain W reference, in float32, on a seeded sample of
the window's calls and compares each row's logits with it.
"""

from __future__ import annotations

import torch

from portbench import flops, generate
from portbench.drivers import serving as S
from portbench.reference import model as R

SAMPLED_CALLS = 8


class Driver:
    unit = "call"
    e2e = "answered_pairs_s"

    def __init__(self, ctx):
        self.ctx = ctx
        self.m = ctx.config["model"]
        self.mix = ctx.mix
        self.fault = ctx.fault

    def setup(self) -> None:
        ctx = self.ctx
        self.batches = generate.answer_batches(ctx.seed, self.mix, self.m)
        self.model = S.serving_model(ctx.config, "w", ctx.seed, ctx.device,
                                     int8=self.fault == "int8")
        for b in self.batches[:2]:
            self._call(b).cpu()
        self.sample = S.Reservoir(ctx.seed, SAMPLED_CALLS)

    def _call(self, b):
        out = self.model.answer_logits(b["image_u8"], b["question"])
        if self.fault == "answer":
            out = torch.roll(out, 1, dims=1)
        return out

    def window(self, seconds: float, tracer) -> dict:
        r = S.closed_loop(self._call, self.batches, seconds,
                          self.mix["ahead"], tracer, self.sample,
                          self.mix["batch"], self.ctx.device,
                          "answer_logits")
        return {"seconds": r["seconds"], "attempted": r["done"] + r["failed"],
                "failed": r["failed"],
                "values": {"answered_pairs_s": r["done"] / r["seconds"]},
                "units": r["calls"],
                "flops": r["calls"] * flops.w_fwd_flops(self.m,
                                                        self.mix["batch"])}

    def release(self) -> None:
        self.model = None
        S.release(self.ctx.device)

    def check(self) -> dict:
        ref = S.w_reference(self.m, self.ctx.seed, self.ctx.device)
        worst = 0.0
        for i, (logits,) in self.sample.items:
            b = self.batches[i]
            err = S.row_errors(logits, ref(b["image_u8"], b["question"]))
            worst = max(worst, float(err.max()))
        return {"logit_err": worst}

    def control(self) -> dict:
        """The reference against itself with its products' operands in
        float8: the logits' error a lower precision reads."""
        dev = self.ctx.device
        ref = S.w_reference(self.m, self.ctx.seed, dev)
        low = S.w_reference(self.m, self.ctx.seed, dev, R.Numerics("fp8"))
        worst = 0.0
        for i, _ in self.sample.items:
            b = self.batches[i]
            err = S.row_errors(low(b["image_u8"], b["question"]).cpu()
                               .numpy(), ref(b["image_u8"], b["question"]))
            worst = max(worst, float(err.max()))
        return {"logit_err": worst}
