"""Checkpoint evaluation CLI (port of lctvqa/eval.py): load an
experiment's EF checkpoint, written by either package, report the
multi-choice accuracy (<unk> predictions masked) and BLEU4 of the greedy
questions on the validation split, and print greedy against
temperature-sampled questions for a few images.

    python -m lctvqa_torch.eval --exp my_exp --input_dir data/vqa/hdf5_64

The model's config comes from the checkpoint (`config_from_state`); a
checkpoint without one takes `--arch_type`, `--img_size`,
`--compute_dtype` and the vocabularies' sizes. It runs on the CUDA
device unless `--device cpu` is given; nothing falls back. `--int8`
quantizes the EF params once (`quant.quantize_model`; the supernet is
refused) and every forward runs int8.

On several ranks, one process a GPU (`--num_devices N` starts them on
this host, 0 = one a card, or `--tp` of them with `--device cpu`; under
torchrun each process is one): the ranks form a (data x model) grid of
W / tp by `--tp` (parallel/tp.py). The VGG classifier's fc6 and fc7 are
split over each model group, the batch over the data axis (W / tp must
divide `--batch_size`), and the accuracy and BLEU4 are the global
batch's. Called inside a process group that already exists, it takes
that group's ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import os
import sys
from typing import Optional

import numpy as np
import torch

from lctvqa_torch import convert
from lctvqa_torch.config import ModelConfig
from lctvqa_torch.data import pipeline
from lctvqa_torch.models import search, vqa_ef
from lctvqa_torch.parallel import distributed, tp as tp_lib
from lctvqa_torch.quant import quantize_model
from lctvqa_torch.text import VocabDict
from lctvqa_torch.train import checkpoint
from lctvqa_torch.train.metrics import (VqaStruct, calc_bleu_scores, mask_unk,
                                        num_correct)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--exp", type=str, required=True)
    p.add_argument("--root_stats_dir", type=str, default="./experiment_data")
    p.add_argument("--input_dir", type=str, default="data/vqa/hdf5_64")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_batches", type=int, default=4)
    p.add_argument("--num_show", type=int, default=4)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--arch_type", type=str, default="darts")
    p.add_argument("--img_size", type=int, default=64)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'; nothing falls back")
    p.add_argument("--int8", action="store_true",
                   help="serve the checkpoint int8-quantized "
                        "(lctvqa_torch/quant.py; fixed/derived encoders only "
                        "— decode a searched supernet to a genotype first)")
    p.add_argument("--tp", type=int, default=1,
                   help="model-parallel degree: fc6/fc7 split over this "
                        "many ranks (parallel/tp.py)")
    p.add_argument("--num_devices", type=int, default=0,
                   help="ranks to start on this host, one process a GPU "
                        "(0 = one a card, or --tp of them with --device "
                        "cpu)")
    p.add_argument("--trusted", action="store_true",
                   help="the JAX package's flag for legacy pickle "
                        "checkpoints; the port reads only ZIP checkpoints "
                        "and refuses a pickle with or without it")
    return p


def _load_ef(state: dict, device):
    """(params, arch) as tensors on `device` from a loaded checkpoint of
    either package (a JAX package's is converted)."""
    trees = convert.checkpoint_params(state, device)
    return trees["ef_params"], trees.get("arch")


def main(argv=None, data: Optional[dict] = None) -> Optional[dict]:
    """-> {"acc", "bleu4", "n"}, or None where this call started the ranks
    as processes of their own. `data`: a loader dict ({"train", "valid"}
    datasets, e.g. `pipeline.loader_from_arrays`) in place of
    `--input_dir`'s h5 files, whose vocabularies it then takes; the
    reference questions of BLEU4 are `--input_dir`'s `valid.npy` either
    way. An in-RAM loader does not cross to spawned ranks: with one, this
    process evaluates, inside the process group where there is one."""
    args = build_parser().parse_args(argv)
    n = 1 if data is not None else distributed.ranks_on_host(
        args.num_devices, args.device, cpu=args.tp)
    return distributed.run_as_ranks(
        functools.partial(_evaluate, data=data),
        list(sys.argv[1:] if argv is None else argv), args.device, n)


def _grid(args) -> Optional[tp_lib.Mesh2D]:
    """The (data x model) grid of a process group, with the JAX package's
    checks; None without one."""
    if not distributed.active():
        return None
    world = distributed.world()
    if world % args.tp:
        raise SystemExit(f"--tp {args.tp} does not divide the {world} "
                         "ranks")
    dp = world // args.tp
    if args.batch_size % dp:
        raise SystemExit(f"--batch_size {args.batch_size} not divisible "
                         f"by the data axis ({dp})")
    return tp_lib.make_mesh_2d(dp, args.tp)


def _evaluate(argv, data: Optional[dict]) -> dict:
    args = build_parser().parse_args(argv)
    grid = _grid(args)
    if grid is None and args.tp > 1:
        raise SystemExit(f"--tp {args.tp} needs {args.tp} ranks or more "
                         "(--num_devices)")
    try:
        return _evaluate_on(args, data, grid)
    finally:
        if grid is not None:
            distributed.set_data_group(None)


def _evaluate_on(args, data: Optional[dict],
                 grid: Optional[tp_lib.Mesh2D]) -> dict:
    device = distributed.local_device(args.device)
    main_rank = distributed.rank() == 0
    show = print if main_rank else (lambda *a, **k: None)

    if data is None:
        val = pipeline.VqaH5Dataset(args.input_dir, "val")
        qv = VocabDict(os.path.join(args.input_dir, "vocab_questions.txt"))
        av = VocabDict(os.path.join(args.input_dir, "vocab_answers.txt"))
    else:
        val, qv, av = data["valid"], data["valid"].qst_vocab, \
            data["valid"].ans_vocab
    vqa_struct = VqaStruct(args.input_dir, "valid.npy")

    exp_dir = os.path.join(args.root_stats_dir, args.exp)
    state = checkpoint.load_state(os.path.join(exp_dir, "ef_model.ckpt"))
    ef_params, arch = _load_ef(state, device)
    cfg = checkpoint.config_from_state(state)
    if cfg is not None:
        # checkpoints are self-describing: rebuild the exact model config
        mcfg = cfg.model
        show(f"model config from checkpoint (lctvqa "
             f"{state.get('lctvqa_version', '?')})")
    else:
        mcfg = ModelConfig(arch_type=args.arch_type, img_size=args.img_size,
                           qst_vocab_size=qv.vocab_size,
                           ans_vocab_size=av.vocab_size,
                           compute_dtype=args.compute_dtype)
    show(f"loaded epoch {state['epoch']} from {exp_dir}")
    if args.int8:
        # one tree rewrite; every forward below dispatches int8 on the
        # quantized conv and linear params
        if mcfg.arch_type == "darts":
            raise SystemExit("--int8 cannot serve the darts supernet; "
                             "retrain with --arch_type derived first "
                             "(python -m lctvqa_torch.genotype <ckpt>)")
        ef_params = quantize_model(ef_params)
        show("serving int8 (weights quantized; LSTM/depthwise stay fp)")
    if arch is not None:
        show("genotype:", search.genotype(arch, mcfg.darts_steps,
                                          mcfg.darts_multiplier))
    elif mcfg.arch_type == "derived":
        show("genotype:", mcfg.genotype, "skeleton:", mcfg.derived_skeleton)
    rows = {}
    if grid is not None:
        ef_params = tp_lib.shard_params(ef_params, grid)
        rows = {"process_index": grid.data_index,
                "process_count": grid.dp}
        show(f"serving on a {grid.dp}x{grid.mp} (data x model) grid")

    def images(batch):
        return pipeline.normalize_images(
            torch.from_numpy(batch["image_u8"]).to(device))

    total_corr = n = n_batches = 0
    total_b4 = 0.0
    batches = itertools.islice(pipeline.epoch_batches(
        val, args.batch_size, np.random.default_rng(0), shuffle=False,
        **rows), args.num_batches)
    split = (contextlib.nullcontext() if grid is None
             else tp_lib.row_parallel(ef_params, grid))
    with torch.no_grad(), split:
        for bi, batch in enumerate(batches):
            img = images(batch)
            qst = torch.from_numpy(batch["question"]).to(device)
            mc = torch.from_numpy(batch["answer_multi_choice"]).to(device)
            ans_logits, _ = vqa_ef.ef_forward(ef_params, arch, mcfg, img,
                                              qst)
            pred = ans_logits.argmax(1)
            total_corr += int(distributed.reduce_stats(sums=(num_correct(
                mask_unk(pred, av.unk2idx), mc),))[0])
            gen_det, gen_ans = vqa_ef.ef_generate(ef_params, arch, mcfg, img)
            gen_det = gen_det.cpu().numpy()
            gen_pred = gen_ans.argmax(1).cpu().numpy()
            n += len(batch["image_u8"]) * (grid.dp if grid else 1)
            n_batches += 1
            names = val.image_names(batch["index"])
            total_b4 += calc_bleu_scores(names, gen_det, qv, vqa_struct)
            if bi == 0:  # every rank: the forward may hold collectives
                gen_sto, _ = vqa_ef.ef_generate(
                    ef_params, arch, mcfg, img, sample_deterministic=False,
                    sample_gen=torch.Generator(device=device).manual_seed(1),
                    temperature=args.temperature)
                gen_sto = gen_sto.cpu().numpy()
            if bi == 0 and main_rank:
                print("\n=== deterministic vs stochastic generation ===")
                for i in range(min(args.num_show, len(names))):
                    print(f"[{names[i]}]")
                    print(f"  gt:     {qv.arr2qst(batch['question'][i])}")
                    print(f"  argmax: {qv.arr2qst(gen_det[i])} "
                          f"-> {av.idx2word(int(gen_pred[i]))}")
                    print(f"  T={args.temperature}: "
                          f"{qv.arr2qst(gen_sto[i])}")
    if n == 0:
        raise ValueError(f"no full batch of {args.batch_size} in the "
                         "validation split")
    if grid is not None:  # each rank's mean over its rows, averaged
        total_b4 = distributed.all_reduce_host([total_b4],
                                               device)[0] / grid.dp
    acc, bleu4 = total_corr / n, total_b4 / n_batches
    show(f"\nval multi-choice acc (unk-masked): {acc:.4f} over {n} items; "
         f"BLEU4 {bleu4:.2f}")
    return {"acc": acc, "bleu4": bleu4, "n": n}


if __name__ == "__main__":
    main()
