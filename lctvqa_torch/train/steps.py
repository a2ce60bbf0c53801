"""Train and eval steps of the LCT loop (port of lctvqa/train/steps.py).

Each step is a plain function on param trees, an optimizer state and a
batch whose tensors lie on the device: it normalizes the uint8 images
there, runs forward and backward, applies the optimizer and returns the
new trees. Losses and counters come back as 0-d tensors on the device;
nothing in a step reads a value back to the host but stage 3's four
dropout seeds. Randomness comes from explicit `torch.Generator`s on the
device: one for dropout, one for sampling the generated questions.
Stage 3, the architecture step, differentiates through two unrolled SGD
steps (optim/architect_lct.py) and runs the plain versions of the
kernels.

Under data parallelism (`parallel/distributed.py`) each rank runs a step
on its rows of the global batch: it differentiates its loss divided by
the number of ranks and sums the gradients over the ranks before the
optimizer (`distributed.grad`), so the clip sees the global gradient and
every rank takes the same update; the losses and counters a step
returns are the global batch's. With one rank these are no-ops.

Stages 1 and 2 name their phases with spans (`trace.py`):
`stage1.forward`, `.backward`, `.optimizer` (the update and the
step's statistics), and `stage2.generate`, `.forward`, `.backward`,
`.optimizer`; a derived EF's image encoder runs inside `stage1.forward`
and `stage2.generate` under `ef.trunk`.
"""

from __future__ import annotations

import contextlib

import torch

from lctvqa_torch.config import Config
from lctvqa_torch.data.pipeline import normalize_images
from lctvqa_torch.models import vqa_ef, vqa_w
from lctvqa_torch.ops import conv as C
from lctvqa_torch.ops.losses import (cross_entropy,
                                     sequence_teacher_forcing_ce, soft_xent)
from lctvqa_torch.optim.architect_lct import make_lct_arch_grad
from lctvqa_torch.optim.optimizers import (arch_optimizer, model_optimizer,
                                           tree_leaves, with_grad)
from lctvqa_torch.parallel import distributed
from lctvqa_torch.trace import span
from lctvqa_torch.train.metrics import mask_unk, num_correct


def make_lct_steps(cfg: Config, unk_idx: int, device):
    """Build the stage1/stage2/stage3/eval step functions and the
    optimizers. Returns a dict of callables, as the JAX package's does."""
    mcfg, tcfg = cfg.model, cfg.train
    mean, std = cfg.data.mean, cfg.data.std
    device = torch.device(device)
    ef_tx = model_optimizer(tcfg)
    w_tx = model_optimizer(tcfg)
    arch_tx = arch_optimizer(tcfg)
    lct_arch_grad = make_lct_arch_grad(mcfg, tcfg)

    def _img(batch):
        return normalize_images(batch["image_u8"].to(device), mean, std)

    def _counts(ans_logits, batch):
        pred = ans_logits.argmax(1)
        mc = batch["answer_multi_choice"]
        return num_correct(pred, mc), num_correct(mask_unk(pred, unk_idx), mc)

    def _trunk_span():
        """The derived EF's image encoder (its trunk and the embedding
        after it) under a span of its own; the other encoders' run in
        their phase's span alone."""
        return (span("ef.trunk") if mcfg.arch_type == "derived"
                else contextlib.nullcontext())

    # ---------------- STAGE 1: EF weight update
    def stage1(ef_params, arch, ef_opt_state, batch, gen):
        with span("stage1.forward"):
            img, qst = _img(batch), batch["question"]
            p = with_grad(ef_params)
            with (C.bn_capture() if mcfg.bn_eval_stats
                  else contextlib.nullcontext()) as cap:
                with _trunk_span():
                    feat = vqa_ef.ef_img_encode(p, arch, mcfg, img, gen,
                                                deterministic=False)
                ans_logits, qst_logits = vqa_ef.ef_forward(
                    p, arch, mcfg, img, qst, gen=gen, deterministic=False,
                    img_feature=feat)
            loss = (cross_entropy(ans_logits, batch["answer_label"])
                    + sequence_teacher_forcing_ce(qst_logits, qst))
        with span("stage1.backward"):
            grads = distributed.grad(loss, tree_leaves(p))
        with span("stage1.optimizer"):
            ef_params, ef_opt_state = ef_tx.update(ef_params, grads,
                                                   ef_opt_state)
            loss, corr1, corr2 = distributed.reduce_stats(
                (loss.detach(),), _counts(ans_logits.detach(), batch))
        if mcfg.bn_eval_stats:
            return ef_params, ef_opt_state, loss, corr1, corr2, cap.stats
        return ef_params, ef_opt_state, loss, corr1, corr2

    def bn_update(running, captured):
        if running is None:
            running = C.init_running_stats(captured)
        return C.update_running_stats(running, captured)

    # ---------------- STAGE 2: W update on real + pseudo QA
    def stage2(w_params, w_opt_state, ef_params, arch, batch, gen,
               sample_gen):
        with span("stage2.generate"), torch.no_grad():
            img, qst = _img(batch), batch["question"]
            labels = batch["answer_label"]
            with _trunk_span():
                feat = vqa_ef.ef_img_encode(ef_params, arch, mcfg, img, gen,
                                            deterministic=False)
            pseudo_qst, pseudo_logits = vqa_ef.ef_generate(
                ef_params, arch, mcfg, img, gen=gen, deterministic=False,
                sample_deterministic=False, sample_gen=sample_gen,
                temperature=tcfg.temperature, img_feature=feat)
            # stage 2 softens WITHOUT temperature, unlike stage 3
            pseudo_ans = torch.softmax(pseudo_logits, dim=-1)
        with span("stage2.forward"):
            p = with_grad(w_params)
            out1 = vqa_w.w_forward(p, mcfg, img, qst, gen,
                                   deterministic=False)
            out2 = vqa_w.w_forward(p, mcfg, img, pseudo_qst, gen,
                                   deterministic=False)
            loss = (cross_entropy(out1, labels)
                    + tcfg.w_lambda * soft_xent(out2, pseudo_ans))
        with span("stage2.backward"):
            grads = distributed.grad(loss, tree_leaves(p))
        with span("stage2.optimizer"):
            w_params, w_opt_state = w_tx.update(w_params, grads, w_opt_state)
            # W is scored on BOTH the real and the pseudo pairs
            corr = ((out1.argmax(1) == labels).sum()
                    + (out2.argmax(1) == pseudo_ans.argmax(1)).sum())
            loss, corr = distributed.reduce_stats((loss.detach(),), (corr,))
        return w_params, w_opt_state, loss, corr

    # ---------------- STAGE 3: architecture step
    def stage3(arch, arch_opt_state, ef_params, w_params, train_batch,
               val_batch, ef_lr, w_lr, gen):
        """The arch gradient through the tri-level unroll, then one step
        of `arch_tx`. -> (arch, arch_opt_state, unrolled validation loss).
        The BatchNorm running statistics are not touched."""
        tb, vb = ({"image": _img(b), "question": b["question"],
                   "answer_label": b["answer_label"]}
                  for b in (train_batch, val_batch))
        g_a, val_loss = lct_arch_grad(arch, ef_params, w_params, tb, vb,
                                      ef_lr, w_lr, gen)
        arch, arch_opt_state = arch_tx.update(arch, tree_leaves(g_a),
                                              arch_opt_state)
        return arch, arch_opt_state, val_loss

    # ---------------- validation
    @torch.no_grad()
    def eval_step(ef_params, arch, batch, bn_running=None):
        img, qst = _img(batch), batch["question"]
        # with running statistics, each model call consumes the whole list
        ctx = ((lambda: C.bn_eval(bn_running)) if bn_running is not None
               else contextlib.nullcontext)
        with ctx():
            ans_logits, _ = vqa_ef.ef_forward(ef_params, arch, mcfg, img, qst,
                                              deterministic=True)
        loss, corr1, corr2 = distributed.reduce_stats(
            (cross_entropy(ans_logits, batch["answer_label"]),),
            _counts(ans_logits, batch))
        with ctx():
            gen_qst, gen_ans = vqa_ef.ef_generate(ef_params, arch, mcfg, img,
                                                  deterministic=True)
        # the generated questions and answers are this rank's rows
        return loss, corr1, corr2, gen_qst, gen_ans

    return {"stage1": stage1, "stage2": stage2, "stage3": stage3,
            "eval": eval_step, "bn_update": bn_update, "ef_tx": ef_tx,
            "w_tx": w_tx, "arch_tx": arch_tx}
