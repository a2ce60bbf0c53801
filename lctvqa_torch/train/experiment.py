"""LCT Experiment: the training loop (port of
lctvqa/train/experiment.py).

Epoch loop: every `arch_update_freq` batches STAGE 3, the architecture
update through the tri-level architect on a validation batch (a cycled
validation iterator), then on every batch STAGE 1, the EF weight update,
and STAGE 2, the W update on real and EF-generated pseudo QA; then
validation (loss, multi-choice accuracy with and without <unk>, BLEU4
of the greedy questions against the reference questions of the npy
records, on a worker thread), the StepLR decay and a checkpoint of both
models. Stage 3 is skipped with `skip_stage3` and for the fixed VGG and
derived EFs, which have no arch. Batches come from the h5 dataset
(data/pipeline.py) or, with `use_old_dataloader`, from the npy records
(data/pipeline_npy.py). After each epoch's checkpoint the six
loss/accuracy lists are written as JSON files and drawn as three PNGs
under the JAX package's names (train/stats.py); a resumed run reads the
lists back and continues them.

Data parallel over torch.distributed where the process group has more
than one rank (`parallel/`; `cfg.mesh`): each rank runs on its own card
(`distributed.local_device`) and takes its rows of every global batch
(the loaders' `process_index`), the steps sum gradients, counters and
BatchNorm statistics over the ranks, and every rank ends each step with
the parameters one process would have on the global batch. Every rank
draws the same shuffles from the seed and its own dropout and sampling
streams (`distributed.rank_seed`); only rank 0 writes the checkpoints,
the log and the statistics files, and every rank reads a checkpoint on
resume. Losses and counters stay on the device during an epoch: the host
reads one value per `report_freq` steps and the sums once at the epoch's
end.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from lctvqa_torch import convert
from lctvqa_torch.config import Config
from lctvqa_torch.data import pipeline, pipeline_npy
from lctvqa_torch.models import search, vqa_ef, vqa_w
from lctvqa_torch.optim.optimizers import set_learning_rate, step_lr, tree_map
from lctvqa_torch.parallel import distributed, mesh as mesh_lib
from lctvqa_torch.train import checkpoint, stats
from lctvqa_torch.train.metrics import VqaStruct, calc_bleu_scores
from lctvqa_torch.train.steps import make_lct_steps
from lctvqa_torch.train.timing import StageTimer


def dev_batch(batch: dict, keys=pipeline.DEVICE_KEYS) -> dict:
    """The fields a step reads, dropping the host-only ones."""
    return {k: v for k, v in batch.items() if k in keys}


def data_mesh(cfg: Config) -> mesh_lib.Mesh:
    """The data axis of `cfg.mesh` over the process group; a kernel flag
    the mesh cannot take raises."""
    mesh = mesh_lib.from_config(cfg.mesh)
    mesh_lib.check_model_config(cfg.model)
    return mesh


def setup_logger(exp_dir: str) -> None:
    """Log to stdout and to `exp_dir`/log.txt."""
    fmt = "%(asctime)s %(message)s"
    logging.basicConfig(stream=sys.stdout, level=logging.INFO, format=fmt,
                        datefmt="%m/%d %I:%M:%S %p", force=True)
    fh = logging.FileHandler(os.path.join(exp_dir, "log.txt"))
    fh.setFormatter(logging.Formatter(fmt))
    logging.getLogger().addHandler(fh)


def check_exp_dir(exp_dir: str, resume: bool) -> None:
    """A directory that holds more than one file is another run's, unless
    it is resumed."""
    if (not resume and os.path.exists(exp_dir)
            and len(os.listdir(exp_dir)) > 1):
        raise RuntimeError(f"exp dir {exp_dir} not empty; delete it or pass "
                           "resume=True")


# the per-epoch lists, each written to <name>.txt, and the plots drawn of
# them: (loss list, accuracy list, title, file)
STATS = ("train_ef_loss", "train_ef_acc", "val_ef_loss", "val_ef_acc",
         "train_w_loss", "train_w_acc")
PLOTS = (("train_ef_loss", "train_ef_acc", "EF Training",
          "ef_train_loss_acc.png"),
         ("val_ef_loss", "val_ef_acc", "EF Validation",
          "ef_val_loss_acc.png"),
         ("train_w_loss", "train_w_acc", "W Training",
          "w_train_loss_acc.png"))


def load_checkpoint(path: str, device, arch_lr: float) -> dict:
    """A checkpoint file of either package as the port's trees on
    `device` (`convert.checkpoint_trees`: the JAX package's optax states
    and HWIO convs are converted)."""
    return convert.checkpoint_trees(checkpoint.load_state(path), device,
                                    arch_lr)


class Experiment:
    def __init__(self, cfg: Config, device="cuda", data: Optional[dict] = None,
                 vgg_params=None):
        """`data`: a loader dict ({"train", "valid"} datasets, e.g. from
        `pipeline.loader_from_arrays`, or `pipeline_npy.get_npy_loader`'s
        with `cfg.data.use_old_dataloader`); by default the h5 files of
        `cfg.data.input_dir` are opened, or its npy records with
        `use_old_dataloader`. The reference questions of
        validation's BLEU4 are `cfg.data.input_dir`'s `valid.npy`, which
        must exist unless `data` is given (validation then reports no
        BLEU4 where there is none). `device`: the CUDA device, or "cpu"
        where the caller asks for it; a missing card raises. With a
        process group of several ranks (`parallel.distributed.initialize`
        first) the loop is data parallel over them."""
        self.mesh = data_mesh(cfg)
        self.is_main = distributed.rank() == 0
        self.device = distributed.local_device(device)
        forced_remat = (cfg.train.architect_mode == "exact-indirect"
                        and not cfg.train.stage3_remat
                        and not cfg.train.skip_stage3)
        if forced_remat:
            # the JAX package's rule: at full width its exact-indirect
            # program does not fit a v5e without remat, so it always remats
            cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                        stage3_remat=True))
        self.cfg = cfg
        self.name = cfg.exp_name
        self.exp_dir = os.path.join(cfg.root_stats_dir, self.name)

        seed = cfg.train.seed
        self.np_rng = np.random.default_rng(seed)
        # explicit generators: dropout and question sampling on the device,
        # a stream a rank; initialization on the host, the same on every
        # rank
        self.gen = torch.Generator(device=self.device).manual_seed(
            distributed.rank_seed(seed))
        self.sample_gen = torch.Generator(device=self.device).manual_seed(
            distributed.rank_seed(seed + 1))
        init_gen = torch.Generator().manual_seed(seed)

        if data is not None:
            self.data = data
        elif cfg.data.use_old_dataloader:
            self.data = pipeline_npy.get_npy_loader(
                cfg.data.input_dir, max_qst_length=cfg.model.max_qst_len,
                max_num_ans=cfg.data.max_num_ans,
                img_size=cfg.model.img_size,
                train_portion=cfg.train.train_portion)
        else:
            self.data = pipeline.get_loader(
                cfg.data.input_dir, cfg.train.batch_size,
                cfg.train.train_portion, preload=cfg.data.preload_images)
        self.qst_vocab = self.data["train"].qst_vocab
        self.ans_vocab = self.data["train"].ans_vocab
        records = os.path.join(cfg.data.input_dir, "valid.npy")
        self.vqa_struct = (VqaStruct(cfg.data.input_dir, "valid.npy")
                           if data is None or os.path.exists(records)
                           else None)

        to_dev = lambda t: t.to(self.device)  # noqa: E731
        ef_params, arch = vqa_ef.init_ef_model(init_gen, cfg.model,
                                               vgg_params=vgg_params)
        self.ef_params = tree_map(to_dev, ef_params)
        self.arch = tree_map(to_dev, arch)
        self.w_params = tree_map(to_dev, vqa_w.init_w_model(
            init_gen, cfg.model, vgg_params=vgg_params))
        self.steps = make_lct_steps(cfg, self.ans_vocab.unk2idx, self.device)
        self.ef_opt = self.steps["ef_tx"].init(self.ef_params)
        self.w_opt = self.steps["w_tx"].init(self.w_params)
        # stepped by stage 3 only
        self.arch_opt = (self.steps["arch_tx"].init(self.arch)
                         if self.arch is not None else None)

        self.epochs = cfg.train.num_epochs
        self.current_epoch = 0
        self.arch_update_freq = cfg.train.arch_update_freq
        self.train_ef_loss, self.train_ef_acc = [], []
        self.val_ef_loss, self.val_ef_acc = [], []
        self.train_w_loss, self.train_w_acc = [], []
        self.timer = StageTimer(self.device)
        self.bn_running = None  # running statistics (model.bn_eval_stats)

        self._load_experiment()
        self.log(f"seed: {seed}")
        self.log(f"device: {self.device}")
        if self.mesh.size > 1:
            self.log(f"data parallel over {self.mesh.size} ranks: "
                     f"{cfg.train.batch_size // self.mesh.size} rows a rank")
        if forced_remat:
            self.log("stage3_remat is forced on for architect_mode "
                     "exact-indirect, as in the JAX package")
        self.log(f"config: {cfg}")
        if cfg.train.packed_dispatch:
            self.log("packed_dispatch is a way of passing the JAX package's "
                     "param trees to a compiled program; it is ignored here")

    # ------------------------------------------------------------------
    def log(self, msg: str):
        logging.info(msg)

    def _load_experiment(self):
        if self.is_main:
            check_exp_dir(self.exp_dir, self.cfg.resume)
        if os.path.exists(self.exp_dir) and self.cfg.resume:
            self.load_model()
            self._read_stats()
        if self.is_main:  # the other ranks log nothing
            os.makedirs(self.exp_dir, exist_ok=True)
            setup_logger(self.exp_dir)
        self.log(f"Exp Name: {self.name}")

    # ------------------------------------------------------------------
    def set_arch_update_freq(self):
        t = self.cfg.train
        freq = int(t.arch_update_freq *
                   (t.arch_freq_decay ** self.current_epoch))
        self.arch_update_freq = max(freq, t.arch_update_freq_min)
        self.log(f"architecture update freq: {self.arch_update_freq}")

    def _epoch_lr(self) -> float:
        t = self.cfg.train
        return step_lr(t.learning_rate, self.current_epoch, t.step_size,
                       t.lr_decay)

    def _epoch_iter(self, split: str, shuffle=True):
        """One epoch of host batches: the npy loader's own, or the h5
        dataset's gathers by the C++ core on cfg.data.num_workers
        threads."""
        rows = {"process_index": self.mesh.rank,
                "process_count": self.mesh.size}
        if self.cfg.data.use_old_dataloader:
            return self.data[split].batches(self.cfg.train.batch_size,
                                            self.np_rng, shuffle=shuffle,
                                            **rows)
        return pipeline.epoch_batches(self.data[split],
                                      self.cfg.train.batch_size, self.np_rng,
                                      shuffle=shuffle,
                                      max_num_ans=self.cfg.data.max_num_ans,
                                      num_workers=self.cfg.data.num_workers,
                                      **rows)

    def _batches(self, split: str, shuffle=True):
        return pipeline.Prefetcher(self._epoch_iter(split, shuffle),
                                   self.device, depth=self.cfg.data.prefetch)

    # ------------------------------------------------------------------
    def run(self):
        for epoch in range(self.current_epoch, self.epochs):
            self.log(f"Starting Epoch: {epoch + 1}")
            if self.arch is not None:
                self.log(f"genotype: {self.genotype()}")
            self.current_epoch = epoch
            self.set_arch_update_freq()
            self.train_epoch()
            self.val()
            self.save_model()
            self._record_stats()
        self.val()

    def genotype(self):
        return search.genotype(self.arch, self.cfg.model.darts_steps,
                               self.cfg.model.darts_multiplier)

    def _cycled_valid(self):
        """Validation batches for stage 3, on the host, without end: the
        first pass's batches over again, as itertools.cycle repeats them
        in the JAX package."""
        return itertools.cycle(self._epoch_iter("valid"))

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in dev_batch(batch).items()}

    # ------------------------------------------------------------------
    def train_step(self, batch, val_batch=None):
        """Stage 3 on (batch, val_batch) when a validation batch is given
        (its W'-val loss logged), then stage 1, then stage 2 unless
        skipped, on one batch. -> (ef_loss, corr1, corr2, w_loss or None,
        w_corr or None, stage-3 loss or None), all 0-d tensors on the
        device."""
        batch = dev_batch(batch)
        s3_loss = None
        if val_batch is not None:
            lr = self._epoch_lr()
            with self.timer.stage("stage3"):
                self.arch, self.arch_opt, s3_loss = self.steps["stage3"](
                    self.arch, self.arch_opt, self.ef_params, self.w_params,
                    batch, self._to_device(val_batch), lr, lr, self.gen)
                shown = float(s3_loss)  # read back for the log, as JAX does
            self.log(f"| TRAIN SET | STAGE3 | W'-Val-Loss: {shown:.4f}")
        bn_stats = None
        with self.timer.stage("stage1"):
            out = self.steps["stage1"](self.ef_params, self.arch,
                                       self.ef_opt, batch, self.gen)
            if self.cfg.model.bn_eval_stats:
                *out, bn_stats = out
                self.bn_running = self.steps["bn_update"](self.bn_running,
                                                          bn_stats)
            self.ef_params, self.ef_opt, loss, c1, c2 = out
        if self.cfg.train.skip_stage2:
            return loss, c1, c2, None, None, s3_loss
        with self.timer.stage("stage2"):
            self.w_params, self.w_opt, loss2, wc = self.steps["stage2"](
                self.w_params, self.w_opt, self.ef_params, self.arch, batch,
                self.gen, self.sample_gen)
        return loss, c1, c2, loss2, wc, s3_loss

    def train_epoch(self):
        t = self.cfg.train
        dataset = self.data["train"]
        n = (len(dataset) // t.batch_size) * t.batch_size
        batch_step_size = max(len(dataset) // t.batch_size, 1)
        # quirk parity: the reference reads W's learning rate (and stage
        # 3's ef_lr and w_lr) from the EF scheduler; they are one value
        lr = self._epoch_lr()
        set_learning_rate(self.ef_opt, lr)
        set_learning_rate(self.w_opt, lr)

        ef_losses, w_losses = [], []
        ef_c1s, ef_c2s, w_corrs = [], [], []
        last_batch = None
        valid_iter = self._cycled_valid()
        do_stage3 = self.arch is not None and not t.skip_stage3
        head = (f"Epoch [{self.current_epoch + 1:02d}/{self.epochs:02d}], "
                "Step [{:04d}/" + f"{batch_step_size:04d}], ")
        for batch_idx, batch in enumerate(self._batches("train")):
            last_batch = batch
            val_batch = (next(valid_iter) if do_stage3
                         and batch_idx % self.arch_update_freq == 0 else None)
            loss, c1, c2, loss2, wc, _ = self.train_step(batch, val_batch)
            ef_losses.append(loss)
            ef_c1s.append(c1)
            ef_c2s.append(c2)
            report = batch_idx % t.report_freq == 0
            if report:
                self.log(f"| TRAIN SET | STAGE1 | {head.format(batch_idx)}"
                         f"EF-Loss: {float(loss):.4f}")
            if loss2 is not None:
                w_losses.append(loss2)
                w_corrs.append(wc)
                if report:
                    self.log(f"| TRAIN SET | STAGE2 | "
                             f"{head.format(batch_idx)}"
                             f"W-Loss: {float(loss2):.4f}")

        def total(xs):
            return torch.stack(xs).sum().item() if xs else 0

        ef_loss = float(total(ef_losses))
        ef_corr1, ef_corr2 = int(total(ef_c1s)), int(total(ef_c2s))
        w_loss, w_corr = float(total(w_losses)), int(total(w_corrs))
        self.train_ef_loss.append(ef_loss / batch_step_size)
        self.train_ef_acc.append(ef_corr2 / max(n, 1))
        self.train_w_loss.append(w_loss / batch_step_size)
        # denominator 2N: W is scored on real AND pseudo QA
        self.train_w_acc.append(w_corr / max(2 * n, 1))
        self.log(
            f"| TRAIN SET | Epoch [{self.current_epoch + 1:02d}/"
            f"{self.epochs:02d}], EF-Loss: {self.train_ef_loss[-1]:.4f} "
            f"EF-Acc(Exp1): {ef_corr1 / max(n, 1):.4f}, "
            f"EF-Acc(Exp2): {self.train_ef_acc[-1]:.4f}, "
            f"W-Loss: {self.train_w_loss[-1]:.4f}, "
            f"W-Acc: {self.train_w_acc[-1]:.4f}")
        self.log(f"| TIMING | {self.timer.summary()}")
        self.timer.reset()
        if last_batch is not None:
            self.evaluate_gen_qst(last_batch)

    def _eval_step(self, batch):
        return self.steps["eval"](
            self.ef_params, self.arch, dev_batch(batch),
            self.bn_running if self.cfg.model.bn_eval_stats else None)

    def evaluate_gen_qst(self, batch):
        """Log ground-truth against generated QA pairs."""
        _, _, _, gen_qst, gen_ans = self._eval_step(batch)
        gen_qst = gen_qst.cpu().numpy()
        gen_pred = gen_ans.argmax(1).cpu().numpy()
        qsts = batch["question"].cpu().numpy()
        labels = batch["answer_label"].cpu().numpy()
        self.log("Evaluating question answer pairs")
        for i in range(min(4, len(gen_qst))):
            self.log(f"ground truth qst: {self.qst_vocab.arr2qst(qsts[i])} "
                     f"ans: {self.ans_vocab.idx2word(int(labels[i]))}")
            self.log(f"generated qst: {self.qst_vocab.arr2qst(gen_qst[i])} "
                     f"ans: {self.ans_vocab.idx2word(int(gen_pred[i]))}")

    # ------------------------------------------------------------------
    def _bleu(self, names, gen_qst) -> float:
        """BLEU4 of one batch's greedy questions (on the BLEU thread: the
        copy to the host waits there, not in the loop)."""
        return calc_bleu_scores(names, gen_qst.cpu().numpy(), self.qst_vocab,
                                self.vqa_struct)

    def val(self):
        t = self.cfg.train
        dataset = self.data["valid"]
        n = (len(dataset) // t.batch_size) * t.batch_size
        batch_step_size = max(len(dataset) // t.batch_size, 1)
        losses, c1s, c2s = [], [], []
        # BLEU (host work) runs on one worker thread, off the steps' path
        bleu_pool = (ThreadPoolExecutor(max_workers=1)
                     if self.vqa_struct is not None else None)
        bleu_futures = []
        for batch_idx, batch in enumerate(self._batches("valid",
                                                        shuffle=False)):
            loss, c1, c2, gen_qst, _ = self._eval_step(batch)
            losses.append(loss)
            c1s.append(c1)
            c2s.append(c2)
            if bleu_pool is not None:
                names = dataset.image_names(np.asarray(batch["index"]))
                bleu_futures.append(bleu_pool.submit(self._bleu, names,
                                                     gen_qst))
            if batch_idx % 100 == 0:
                self.log(
                    f"| VALID SET | Epoch [{self.current_epoch + 1:02d}/"
                    f"{self.epochs:02d}], Step [{batch_idx:04d}/"
                    f"{batch_step_size:04d}], Loss: {float(loss):.4f}")
        running_loss = float(torch.stack(losses).sum()) if losses else 0.0
        corr1 = int(torch.stack(c1s).sum()) if c1s else 0
        corr2 = int(torch.stack(c2s).sum()) if c2s else 0
        bleu = ""
        if bleu_pool is not None:
            # each rank's mean over its rows; the global batch's is their mean
            total_b4 = distributed.all_reduce_host(
                [sum(f.result() for f in bleu_futures)],
                self.device)[0] / self.mesh.size
            bleu_pool.shutdown()
            bleu = f" BLEU4: {total_b4 / batch_step_size:.4f}"
        self.val_ef_loss.append(running_loss / batch_step_size)
        self.val_ef_acc.append(corr2 / max(n, 1))
        self.log(
            f"| VALID SET | Epoch [{self.current_epoch + 1:02d}/"
            f"{self.epochs:02d}], Loss: {self.val_ef_loss[-1]:.4f} "
            f"Acc(Exp1): {corr1 / max(n, 1):.4f}, "
            f"Acc(Exp2): {self.val_ef_acc[-1]:.4f}{bleu}")

    # ------------------------------------------------------------------
    def save_model(self):
        if not self.is_main:
            return
        checkpoint.save_state(
            os.path.join(self.exp_dir, "ef_model.ckpt"),
            {"ef_params": self.ef_params, "ef_opt": self.ef_opt,
             "arch": self.arch, "arch_opt": self.arch_opt,
             "bn_running": self.bn_running,
             "epoch": self.current_epoch + 1},
            config=self.cfg)
        checkpoint.save_state(
            os.path.join(self.exp_dir, "w_model.ckpt"),
            {"w_params": self.w_params, "w_opt": self.w_opt,
             "epoch": self.current_epoch + 1},
            config=self.cfg)

    def _read_stats(self):
        for name in STATS:
            setattr(self, name, stats.read_file_in_dir(self.exp_dir,
                                                       f"{name}.txt"))

    def _record_stats(self):
        if not self.is_main:
            return
        for name in STATS:
            stats.write_to_file_in_dir(self.exp_dir, f"{name}.txt",
                                       getattr(self, name))
        for loss, acc, title, fname in PLOTS:
            stats.plot_loss_acc(getattr(self, loss), getattr(self, acc),
                                title, os.path.join(self.exp_dir, fname))

    def load_model(self):
        """Both models' checkpoints, written by either package."""
        lr = self.cfg.train.arch_learning_rate
        state = load_checkpoint(os.path.join(self.exp_dir, "ef_model.ckpt"),
                                self.device, lr)
        self.ef_params, self.ef_opt = state["ef_params"], state["ef_opt"]
        if state["arch"] is not None:
            self.arch = state["arch"]
        self.arch_opt = state["arch_opt"]
        if state.get("bn_running") is not None:
            self.bn_running = state["bn_running"]
        self.current_epoch = state["epoch"]
        w_path = os.path.join(self.exp_dir, "w_model.ckpt")
        if checkpoint.exists(w_path):
            w_state = load_checkpoint(w_path, self.device, lr)
            self.w_params, self.w_opt = w_state["w_params"], w_state["w_opt"]
