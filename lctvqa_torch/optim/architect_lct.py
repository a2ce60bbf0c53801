"""LCT tri-level architect, stage 3 (port of lctvqa/optim/architect_lct.py).

The reference's stage-3 pipeline:
  1. EF' = EF - ef_lr * grad_EF [CE_ans + CE_qst](train)
  2. (pseudo_qst, pseudo_ans) = EF'.generate(img_train);
     pseudo_ans = softmax(ans / TEMPERATURE)
  3. W'  = W - w_lr * grad_W soft_loss(real + pseudo)
  4. grad_w' = grad_{W'} CE(W'(val))
  5. kappa = finite-difference HVP of W's soft loss wrt EF' along grad_w'
  6. gamma = finite-difference HVP of EF's train loss wrt arch along kappa
  7. alpha.grad = gamma * ef_lr * w_lr

'exact' is one autograd pass through the composed two-level unroll,

    d/d_alpha  L_val( W - w_lr * grad_W L_soft(W, pseudo(EF'(alpha))) ),

the two inner gradients taken with `create_graph=True`; its chain rule is
gamma * ef_lr * w_lr (the two minus signs of the inner SGD steps cancel).
'exact-indirect' detaches alpha inside the pseudo-QA generation only,
which drops the direct alpha -> generate -> W' path as the reference's
finite differences do (they perturb EF's weights, never alpha). 'fd'
replays steps 1-7 with R = 1e-2 / ||v||; the pseudo QA is regenerated in
each kappa probe from the same EF' and the same dropout draws.

Kept reference quirks: pseudo answers softened with TEMPERATURE; greedy
pseudo questions, integer tokens that carry no gradient; W's VGG trunk
frozen (its leaves get no gradient and do not move in the unroll).

Every kernel is swapped for its plain version inside the closures, as
the JAX package does: the port's kernel Functions are differentiable once
only. `ops.conv.second_order` routes BatchNorm and fp32 convolutions the
same way for every forward and backward of the call, including those a
checkpoint (`stage3_remat`) recomputes.

Under data parallelism every gradient of the unroll, the inner SGD
steps, the outer gradient and fd's perturbed ones, is the global batch's
(`architect.grads`: summed over the ranks, differentiably in exact
mode), and the validation loss returned is the global one.

Randomness: four seeds per call from the caller's dropout generator, for
EF's train loss, the pseudo-QA generation, W's soft loss and the
validation loss (r1-r4 of the JAX package); each use builds a fresh
generator from its seed, so the probes of 'fd' and a recomputed forward
draw the same masks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from lctvqa_torch.config import ModelConfig, TrainConfig
from lctvqa_torch.models import vqa_ef, vqa_w
from lctvqa_torch.ops import conv as C
from lctvqa_torch.optim.architect import (central_difference, draw_seeds,
                                          global_loss, global_norm, grads,
                                          perturb, seeded, zero_filled)
from lctvqa_torch.optim.optimizers import (sgd_step, tree_from_leaves,
                                           tree_map, with_grad)

MODES = ("exact", "exact-indirect", "fd")


def plain_model_config(mcfg: ModelConfig) -> ModelConfig:
    """`mcfg` with every kernel flag off."""
    return dataclasses.replace(mcfg, use_pallas_lstm=False,
                               pallas_seq_lstm=False, pallas_generate=False,
                               pallas_mixed_op=False)


def make_lct_arch_grad(mcfg: ModelConfig, tcfg: TrainConfig,
                       mode: Optional[str] = None):
    """Returns arch_grad(arch, ef_params, w_params, train_batch,
    val_batch, ef_lr, w_lr, gen) -> (gradient shaped like arch, unrolled
    validation loss as a 0-d tensor). Batches hold the normalized
    "image", "question" and "answer_label" on the device; `gen` is the
    dropout generator the call's seeds come from."""
    mode = mode or tcfg.architect_mode
    if mode not in MODES:
        raise ValueError(f"architect mode {mode!r} is not one of {MODES}")
    mcfg = plain_model_config(mcfg)
    temp, w_lambda = tcfg.temperature, tcfg.w_lambda

    # every closure opens second_order itself: a checkpoint recomputes its
    # forward inside the outer backward, on whatever thread autograd uses
    def ef_train_loss(ef_p, a, batch, seed):
        with C.second_order():
            return vqa_ef.ef_loss(ef_p, a, mcfg, batch["image"],
                                  batch["question"], batch["answer_label"],
                                  gen=seeded(seed, batch["image"].device),
                                  deterministic=False)

    def pseudo_qa(ef_p, a, img, seed):
        """EF's greedy question and its answer, softened by TEMPERATURE;
        the token loop runs without a graph (ef_qst_generate)."""
        with C.second_order():
            pq, pa_logits = vqa_ef.ef_generate(
                ef_p, a, mcfg, img, gen=seeded(seed, img.device),
                deterministic=False, sample_deterministic=True)
        return pq, torch.softmax(pa_logits / temp, dim=-1)

    def w_soft(w_p, batch, pq, pa, seed):
        with C.second_order():
            return vqa_w.w_soft_loss(w_p, mcfg, batch["image"],
                                     batch["question"], batch["answer_label"],
                                     pq, pa, w_lambda,
                                     gen=seeded(seed, batch["image"].device),
                                     deterministic=False)

    def w_val_loss(w_p, batch, seed):
        with C.second_order():
            return vqa_w.w_loss(w_p, mcfg, batch["image"], batch["question"],
                                batch["answer_label"],
                                gen=seeded(seed, batch["image"].device),
                                deterministic=False)

    def remat(fn):
        """The forward recomputed in the outer backward instead of held
        (TrainConfig.stage3_remat). Every draw comes from a generator
        seeded inside `fn`, so no RNG state needs keeping."""
        if not tcfg.stage3_remat:
            return fn
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        preserve_rng_state=False)

    ef_inner, w_inner = remat(ef_train_loss), remat(w_soft)
    indirect_only = mode == "exact-indirect"

    def exact(arch, ef_params, w_params, train_batch, val_batch, ef_lr, w_lr,
              gen):
        r1, r2, r3, r4 = draw_seeds(gen, 4)
        with torch.enable_grad(), C.second_order():
            a, ef = with_grad(arch), with_grad(ef_params)
            g_ef = grads(ef_inner(ef, a, train_batch, r1), ef,
                         create_graph=True)
            ef2 = sgd_step(ef, g_ef, ef_lr)
            # 'exact-indirect' drops the direct alpha -> generate path
            a_gen = tree_map(torch.Tensor.detach, a) if indirect_only else a
            pq, pa = pseudo_qa(ef2, a_gen, train_batch["image"], r2)
            w = with_grad(w_params)
            g_w = grads(w_inner(w, train_batch, pq, pa, r3), w,
                        create_graph=True)
            w2 = sgd_step(w, g_w, w_lr)
            val_loss = w_val_loss(w2, val_batch, r4)
            g_a = zero_filled(a, grads(val_loss, a))
        return tree_from_leaves(arch, g_a), global_loss(val_loss)

    def fd(arch, ef_params, w_params, train_batch, val_batch, ef_lr, w_lr,
           gen):
        r1, r2, r3, r4 = draw_seeds(gen, 4)
        img = train_batch["image"]
        with torch.enable_grad(), C.second_order():
            # (1) unroll EF
            ef = with_grad(ef_params)
            ef2 = sgd_step(ef_params, grads(
                ef_train_loss(ef, arch, train_batch, r1), ef), ef_lr)
            # (2) pseudo QA from EF'
            with torch.no_grad():
                pq, pa = pseudo_qa(ef2, arch, img, r2)
            # (3) unroll W on the soft loss
            w = with_grad(w_params)
            w2 = with_grad(sgd_step(w_params, grads(
                w_soft(w, train_batch, pq, pa, r3), w), w_lr))
            # (4) grad_w' of the validation loss
            val_loss = w_val_loss(w2, val_batch, r4)
            grad_wprime = zero_filled(w2, grads(val_loss, w2))

            # (5) kappa: HVP of W's soft loss wrt EF' along grad_w', the
            # pseudo QA regenerated in each probe from the same EF' and draws
            def soft_wrt_ef(w_p):
                ef_p = with_grad(ef2)
                pq_i, pa_i = pseudo_qa(ef_p, arch, img, r2)
                return zero_filled(ef_p, grads(
                    w_soft(w_p, train_batch, pq_i, pa_i, r3), ef_p))

            r_1 = 1e-2 / global_norm(grad_wprime)
            kappa = central_difference(
                *(soft_wrt_ef(perturb(w_params, grad_wprime, sign * r_1))
                  for sign in (1.0, -1.0)), r_1)

            # (6) gamma: HVP of EF's train loss wrt arch along kappa
            def arch_grad_at(ef_p):
                a = with_grad(arch)
                return zero_filled(a, grads(
                    ef_train_loss(ef_p, a, train_batch, r1), a))

            r_2 = 1e-2 / global_norm(kappa)
            gamma = central_difference(
                *(arch_grad_at(perturb(ef_params, kappa, sign * r_2))
                  for sign in (1.0, -1.0)), r_2)
        # (7) the scaling of the alpha gradient
        g_a = [g * ef_lr * w_lr for g in gamma]
        return tree_from_leaves(arch, g_a), global_loss(val_loss)

    return fd if mode == "fd" else exact
