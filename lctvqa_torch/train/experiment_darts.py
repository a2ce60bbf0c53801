"""The 2-stage DARTS experiment and its unified variant (port of
lctvqa/train/experiment_darts.py).

Loop: every `arch_update_freq` batches, batch 0 included, one step of
the DARTS second-order architect (optim/architect.py, the mode
`architect_mode` names: 'exact', or the finite difference for any other
mode, as in the JAX package) on the next batch of a cycled validation
iterator with eta the epoch's learning rate, then a weight update: loss
= answer CE + shifted question CE (or the question CE alone with
`qst_only`), or the unified model's next-token CE. The frequency is not
decayed, unlike the LCT loop's. Validation: loss (both terms), the
multi-choice accuracy of the prediction with `<unk>` masked and BLEU4
of the greedy questions; the unified variant scores the share of exact
answer strings and BLEU4 of the greedy streams. Checkpoints each epoch:
`vqa_model.ckpt` (params, their Adam state, epoch), `arch_par.ckpt` (arch
and its Adam state) and `stats.ckpt`.

The steps run on the device of their batches; the architect step runs
the plain versions of the kernels (`architect_lct.plain_model_config`,
`ops.conv.second_order`), as the JAX package does, and launches none.
Data: the npy records of `cfg.data.input_dir` (data/pipeline_npy.py),
whose `valid.npy` gives BLEU4's references. A resumed experiment reads
the checkpoints of either package.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from lctvqa_torch.config import Config
from lctvqa_torch.data import pipeline, pipeline_npy
from lctvqa_torch.data.pipeline import normalize_images
from lctvqa_torch.models import search, unified as unified_model, vqa_ef
from lctvqa_torch.ops.losses import cross_entropy, sequence_teacher_forcing_ce
from lctvqa_torch.optim.architect import make_darts_arch_grad
from lctvqa_torch.optim.architect_lct import plain_model_config
from lctvqa_torch.optim.optimizers import (arch_optimizer, model_optimizer,
                                           set_learning_rate, step_lr,
                                           tree_leaves, tree_map, with_grad)
from lctvqa_torch.train import checkpoint
from lctvqa_torch.train.experiment import (check_exp_dir, dev_batch,
                                           load_checkpoint, setup_logger,
                                           training_device)
from lctvqa_torch.train.metrics import (VqaStruct, calc_bleu_scores,
                                        calc_bleu_scores_unified, mask_unk,
                                        num_correct, unified_ans_acc)

DEVICE_KEYS = pipeline.DEVICE_KEYS + ("qa_str",)


def _make_arch_step(cfg: Config, loss_fn):
    """arch_step(arch, arch_opt_state, params, train_batch, val_batch, eta,
    gen) -> (arch, arch_opt_state, validation loss): the arch gradient of
    `loss_fn` (which takes batches with normalized "image"s) and one step
    of the arch optimizer."""
    arch_tx = arch_optimizer(cfg.train)
    arch_grad = make_darts_arch_grad(loss_fn, mode=cfg.train.architect_mode)
    mean, std = cfg.data.mean, cfg.data.std

    def arch_step(arch, arch_opt_state, params, train_batch, val_batch, eta,
                  gen):
        tb, vb = (dict(b, image=normalize_images(b["image_u8"], mean, std))
                  for b in (train_batch, val_batch))
        g_a, val_loss = arch_grad(params, arch, tb, vb, eta, gen)
        arch, arch_opt_state = arch_tx.update(arch, tree_leaves(g_a),
                                              arch_opt_state)
        return arch, arch_opt_state, val_loss

    return arch_step, arch_tx


def _apply(tx, params, opt_state, loss):
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
    return tx.update(params, grads, opt_state)


def make_darts_steps(cfg: Config, unk_idx: int, qst_only: bool = False):
    """The steps of the 2-stage loop: {"arch", "train", "eval", "tx",
    "arch_tx"}. Losses and counts come back as 0-d tensors on the
    device."""
    mcfg = cfg.model
    mean, std = cfg.data.mean, cfg.data.std
    tx = model_optimizer(cfg.train)
    arch_mcfg = plain_model_config(mcfg)

    def arch_loss(p, a, batch, gen):
        return vqa_ef.ef_loss(p, a, arch_mcfg, batch["image"],
                              batch["question"], batch["answer_label"],
                              gen=gen, deterministic=False, qst_only=qst_only)

    arch_step, arch_tx = _make_arch_step(cfg, arch_loss)

    def train_step(params, opt_state, arch, batch, gen):
        p = with_grad(params)
        loss = vqa_ef.ef_loss(p, arch, mcfg,
                              normalize_images(batch["image_u8"], mean, std),
                              batch["question"], batch["answer_label"],
                              gen=gen, deterministic=False, qst_only=qst_only)
        params, opt_state = _apply(tx, p, opt_state, loss)
        return params, opt_state, loss.detach()

    @torch.no_grad()
    def eval_step(params, arch, batch):
        """-> (answer + question CE, correct unk-masked answers, greedy
        questions int32 [B, T])."""
        img = normalize_images(batch["image_u8"], mean, std)
        ans_logits, qst_logits = vqa_ef.ef_forward(
            params, arch, mcfg, img, batch["question"], deterministic=True)
        loss = (cross_entropy(ans_logits, batch["answer_label"])
                + sequence_teacher_forcing_ce(qst_logits, batch["question"]))
        corr = num_correct(mask_unk(ans_logits.argmax(1), unk_idx),
                           batch["answer_multi_choice"])
        gen_qst, _ = vqa_ef.ef_generate(params, arch, mcfg, img,
                                        deterministic=True)
        return loss, corr, gen_qst

    return {"arch": arch_step, "train": train_step, "eval": eval_step,
            "tx": tx, "arch_tx": arch_tx}


def make_unified_steps(cfg: Config):
    """The unified model's steps: {"arch", "train" (-> params, opt state,
    loss, argmax stream), "eval" (-> loss, argmax stream, greedy stream),
    "tx", "arch_tx"}."""
    mcfg = cfg.model
    mean, std = cfg.data.mean, cfg.data.std
    tx = model_optimizer(cfg.train)
    arch_mcfg = plain_model_config(mcfg)

    def arch_loss(p, a, batch, gen):
        return unified_model.unified_loss(p, a, arch_mcfg, batch["image"],
                                          batch["qa_str"], gen=gen,
                                          deterministic=False)

    arch_step, arch_tx = _make_arch_step(cfg, arch_loss)

    def train_step(params, opt_state, arch, batch, gen):
        p = with_grad(params)
        logits = unified_model.unified_forward(
            p, arch, mcfg, normalize_images(batch["image_u8"], mean, std),
            batch["qa_str"], gen=gen, deterministic=False)
        loss = sequence_teacher_forcing_ce(logits, batch["qa_str"])
        params, opt_state = _apply(tx, p, opt_state, loss)
        return params, opt_state, loss.detach(), logits.detach().argmax(2)

    @torch.no_grad()
    def eval_step(params, arch, batch):
        img = normalize_images(batch["image_u8"], mean, std)
        logits = unified_model.unified_forward(params, arch, mcfg, img,
                                               batch["qa_str"])
        loss = sequence_teacher_forcing_ce(logits, batch["qa_str"])
        qa_gen = unified_model.unified_generate(params, arch, mcfg, img)
        return loss, logits.argmax(2), qa_gen

    return {"arch": arch_step, "train": train_step, "eval": eval_step,
            "tx": tx, "arch_tx": arch_tx}


def _mean(xs) -> float:
    return float(torch.stack(xs).sum()) / max(len(xs), 1) if xs else 0.0


class DartsExperiment:
    """The 2-stage loop over the npy records."""

    unified = False

    def __init__(self, cfg: Config, qst_only: bool = False, device="cuda",
                 data: Optional[dict] = None):
        """`device`: the CUDA device, or "cpu" where the caller asks for
        it; a missing card raises. `data`: a loader dict ({"train",
        "valid"}), by default `pipeline_npy.get_npy_loader` over
        `cfg.data.input_dir` (which holds BLEU4's valid.npy either way)."""
        self.device = training_device(device)
        self.cfg = cfg
        self.qst_only = qst_only
        self.exp_dir = os.path.join(cfg.root_stats_dir, cfg.exp_name)
        check_exp_dir(self.exp_dir, cfg.resume)
        os.makedirs(self.exp_dir, exist_ok=True)
        setup_logger(self.exp_dir)
        seed = cfg.train.seed
        self.np_rng = np.random.default_rng(seed)
        # dropout and the arch step's seeds on the device, initialization
        # on the host
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.data = data if data is not None else pipeline_npy.get_npy_loader(
            cfg.data.input_dir, max_qst_length=cfg.model.max_qst_len,
            img_size=cfg.model.img_size, unified=self.unified)
        self.qst_vocab = self.data["train"].qst_vocab
        self.ans_vocab = self.data["train"].ans_vocab
        self.vqa_struct = VqaStruct(cfg.data.input_dir, "valid.npy")
        self._init_model(torch.Generator().manual_seed(seed))
        self.current_epoch = 0
        self.epochs = cfg.train.num_epochs
        self.arch_update_freq = cfg.train.arch_update_freq
        self.train_loss, self.train_acc = [], []
        self.val_loss, self.val_acc, self.val_b4 = [], [], []
        if cfg.resume:
            self.load_model()
            self.load_stats()
        mode = self.cfg.train.architect_mode
        self.log(f"device: {self.device}; architect_mode {mode}: the "
                 f"{'exact' if mode == 'exact' else 'finite-difference'} "
                 "DARTS architect")

    def _init_model(self, gen):
        to_dev = lambda t: t.to(self.device)  # noqa: E731
        params, arch = vqa_ef.init_ef_model(gen, self.cfg.model)
        self._set_model(tree_map(to_dev, params), tree_map(to_dev, arch),
                        make_darts_steps(self.cfg, self.ans_vocab.unk2idx,
                                         self.qst_only))

    def _set_model(self, params, arch, steps):
        self.params, self.arch, self.steps = params, arch, steps
        self.opt = steps["tx"].init(params)
        self.arch_opt = (steps["arch_tx"].init(arch) if arch is not None
                         else None)

    def log(self, msg):
        logging.info(msg)

    def _epoch_lr(self):
        t = self.cfg.train
        return step_lr(t.learning_rate, self.current_epoch, t.step_size,
                       t.lr_decay)

    def _batches(self, split: str, shuffle: bool = True):
        return pipeline.Prefetcher(
            self.data[split].batches(self.cfg.train.batch_size, self.np_rng,
                                     shuffle=shuffle),
            self.device, depth=self.cfg.data.prefetch,
            device_keys=DEVICE_KEYS)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in dev_batch(batch, DEVICE_KEYS).items()}

    def run(self):
        for epoch in range(self.current_epoch, self.epochs):
            self.current_epoch = epoch
            if self.arch is not None:
                self.log("genotype: " + str(search.genotype(
                    self.arch, self.cfg.model.darts_steps,
                    self.cfg.model.darts_multiplier)))
            self.train_epoch()
            self.val()
            self.save_model()
            self.save_stats()

    def _train_batches(self, lr: float):
        """The epoch's device batches, each after the arch step that falls
        on it, logged."""
        valid_iter = itertools.cycle(self.data["valid"].batches(
            self.cfg.train.batch_size, self.np_rng))
        for batch_idx, batch in enumerate(self._batches("train")):
            batch = dev_batch(batch, DEVICE_KEYS)
            if self.arch is not None and \
                    batch_idx % self.arch_update_freq == 0:
                self.arch, self.arch_opt, v = self.steps["arch"](
                    self.arch, self.arch_opt, self.params, batch,
                    self._to_device(next(valid_iter)), lr, self.gen)
                self.log(f"| ARCH STEP | val-loss {float(v):.4f}")
            yield batch_idx, batch

    def _report(self, batch_idx, loss):
        if batch_idx % self.cfg.train.report_freq == 0:
            self.log(f"| TRAIN | epoch {self.current_epoch + 1} "
                     f"step {batch_idx} loss {float(loss):.4f}")

    def train_epoch(self):
        lr = self._epoch_lr()
        set_learning_rate(self.opt, lr)
        losses = []
        for batch_idx, batch in self._train_batches(lr):
            self.params, self.opt, loss = self.steps["train"](
                self.params, self.opt, self.arch, batch, self.gen)
            losses.append(loss)
            self._report(batch_idx, loss)
        self.train_loss.append(_mean(losses))

    def val(self):
        losses, corrs, n = [], [], 0
        # the BLEU of a batch (host work) on a worker thread, off the
        # steps' path; its copy to the host waits there
        with ThreadPoolExecutor(max_workers=1) as pool:
            futures = []
            for batch in self._batches("valid", shuffle=False):
                loss, corr, gen_qst = self.steps["eval"](
                    self.params, self.arch, dev_batch(batch, DEVICE_KEYS))
                losses.append(loss)
                corrs.append(corr)
                futures.append(pool.submit(
                    lambda nm, gq: calc_bleu_scores(
                        nm, gq.cpu().numpy(), self.qst_vocab,
                        self.vqa_struct), batch["image_name"], gen_qst))
                n += len(batch["image_u8"])
            total_b4 = sum(f.result() for f in futures)
        self.val_loss.append(_mean(losses))
        self.val_acc.append(int(torch.stack(corrs).sum()) / max(n, 1)
                            if corrs else 0.0)
        self.val_b4.append(total_b4 / max(len(futures), 1))
        self.log(f"| VAL | loss {self.val_loss[-1]:.4f} "
                 f"acc {self.val_acc[-1]:.4f} b4 {self.val_b4[-1]:.4f}")

    # ------------------------------------------------------------------
    def save_model(self):
        checkpoint.save_state(
            os.path.join(self.exp_dir, "vqa_model.ckpt"),
            {"params": self.params, "opt": self.opt,
             "epoch": self.current_epoch + 1}, config=self.cfg)
        if self.arch is not None:
            checkpoint.save_state(
                os.path.join(self.exp_dir, "arch_par.ckpt"),
                {"arch": self.arch, "arch_opt": self.arch_opt},
                config=self.cfg)

    def _load(self, name: str) -> dict:
        return load_checkpoint(os.path.join(self.exp_dir, name),
                               self.device,
                               self.cfg.train.arch_learning_rate)

    def load_model(self):
        st = self._load("vqa_model.ckpt")
        self.params, self.opt = st["params"], st["opt"]
        self.current_epoch = st["epoch"]
        if checkpoint.exists(os.path.join(self.exp_dir, "arch_par.ckpt")):
            st = self._load("arch_par.ckpt")
            self.arch, self.arch_opt = st["arch"], st["arch_opt"]

    def save_stats(self):
        checkpoint.save_state(
            os.path.join(self.exp_dir, "stats.ckpt"),
            {"train_loss": self.train_loss, "train_acc": self.train_acc,
             "val_loss": self.val_loss, "val_acc": self.val_acc,
             "val_b4": self.val_b4}, config=self.cfg)

    def load_stats(self):
        path = os.path.join(self.exp_dir, "stats.ckpt")
        if not checkpoint.exists(path):
            return
        st = checkpoint.load_state(path)
        for k in ("train_loss", "train_acc", "val_loss", "val_acc",
                  "val_b4"):
            setattr(self, k, [float(v) for v in st[k]])


class DartsExperimentUnified(DartsExperiment):
    """The unified QA-stream variant. The model's question vocabulary is
    the unified one: its size replaces `qst_vocab_size` in the config,
    which the checkpoints carry."""

    unified = True

    def _init_model(self, gen):
        uv = self.data["train"].unified_vocab
        self.unified_vocab = uv
        self.cfg = self.cfg.replace(model=dataclasses.replace(
            self.cfg.model, qst_vocab_size=uv.vocab_size))
        to_dev = lambda t: t.to(self.device)  # noqa: E731
        params, arch = unified_model.init_unified_model(gen, self.cfg.model)
        self._set_model(tree_map(to_dev, params), tree_map(to_dev, arch),
                        make_unified_steps(self.cfg))

    def _ans_acc(self, qa_str, qa_pred) -> float:
        return unified_ans_acc(qa_str.cpu().numpy(), qa_pred.cpu().numpy(),
                               self.unified_vocab)

    def train_epoch(self):
        lr = self._epoch_lr()
        set_learning_rate(self.opt, lr)
        losses = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            accs = []
            for batch_idx, batch in self._train_batches(lr):
                self.params, self.opt, loss, qa_pred = self.steps["train"](
                    self.params, self.opt, self.arch, batch, self.gen)
                losses.append(loss)
                accs.append(pool.submit(self._ans_acc, batch["qa_str"],
                                        qa_pred))
                self._report(batch_idx, loss)
            total_acc = sum(f.result() for f in accs)
        self.train_loss.append(_mean(losses))
        self.train_acc.append(total_acc / max(len(accs), 1))

    def val(self):
        losses = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            accs, bleus = [], []
            for batch in self._batches("valid", shuffle=False):
                loss, qa_pred, qa_gen = self.steps["eval"](
                    self.params, self.arch, dev_batch(batch, DEVICE_KEYS))
                losses.append(loss)
                accs.append(pool.submit(self._ans_acc, batch["qa_str"],
                                        qa_pred))
                bleus.append(pool.submit(
                    lambda nm, qa: calc_bleu_scores_unified(
                        nm, qa.cpu().numpy(), self.unified_vocab,
                        self.vqa_struct), batch["image_name"], qa_gen))
            nb = max(len(accs), 1)
            total_acc = sum(f.result() for f in accs)
            total_b4 = sum(f.result() for f in bleus)
        self.val_loss.append(_mean(losses))
        self.val_acc.append(total_acc / nb)
        self.val_b4.append(total_b4 / nb)
        self.log(f"| VAL | loss {self.val_loss[-1]:.4f} "
                 f"ans-acc {self.val_acc[-1]:.4f} "
                 f"b4 {self.val_b4[-1]:.4f}")
