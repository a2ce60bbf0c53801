"""Checkpoint evaluation CLI (port of lctvqa/eval.py): load an
experiment's EF checkpoint, written by either package, report the
multi-choice accuracy (<unk> predictions masked) and BLEU4 of the greedy
questions on the validation split, and print greedy against
temperature-sampled questions for a few images.

    python -m lctvqa_torch.eval --exp my_exp --input_dir data/vqa/hdf5_64

The model's config comes from the checkpoint (`config_from_state`); a
checkpoint without one takes `--arch_type`, `--img_size`,
`--compute_dtype` and the vocabularies' sizes. It runs on the CUDA
device unless `--device cpu` is given; nothing falls back. `--int8` and
`--tp` above 1 are not ported and raise.
"""

from __future__ import annotations

import argparse
import itertools
import os
from typing import Optional

import numpy as np
import torch

from lctvqa_torch import convert
from lctvqa_torch.config import ModelConfig
from lctvqa_torch.data import pipeline
from lctvqa_torch.models import search, vqa_ef
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
                   help="not ported (ROADMAP.md, queue 1 item 6)")
    p.add_argument("--tp", type=int, default=1,
                   help="model-parallel degree; only 1 is ported "
                        "(ROADMAP.md, queue 1 item 7)")
    return p


def _load_ef(state: dict, device):
    """(params, arch) as tensors on `device` from a loaded checkpoint of
    either package: the port's has its Adam state as a dict, the JAX
    package's as optax's namedtuples, and its conv weights HWIO."""
    if not isinstance(state.get("ef_opt"), dict):
        state = convert.checkpoint_from_jax(
            {k: state.get(k) for k in ("ef_params", "arch")}, device)
        return state["ef_params"], state["arch"]
    arch = state.get("arch")
    return (convert.as_tensors(state["ef_params"], device),
            None if arch is None else convert.as_tensors(arch, device))


def main(argv=None, data: Optional[dict] = None) -> dict:
    """-> {"acc", "bleu4", "n"}. `data`: a loader dict ({"train",
    "valid"} datasets, e.g. `pipeline.loader_from_arrays`) in place of
    `--input_dir`'s h5 files, whose vocabularies it then takes; the
    reference questions of BLEU4 are `--input_dir`'s `valid.npy` either
    way."""
    args = build_parser().parse_args(argv)
    if args.int8:
        raise NotImplementedError("--int8 (quant.py) is not ported: "
                                  "ROADMAP.md, queue 1 item 6")
    if args.tp > 1:
        raise NotImplementedError("--tp > 1 (parallel/tp.py) is not "
                                  "ported: ROADMAP.md, queue 1 item 7")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("eval runs on a CUDA device and none is "
                           "available; pass --device cpu to run on the CPU")

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
        print(f"model config from checkpoint (lctvqa "
              f"{state.get('lctvqa_version', '?')})")
    else:
        mcfg = ModelConfig(arch_type=args.arch_type, img_size=args.img_size,
                           qst_vocab_size=qv.vocab_size,
                           ans_vocab_size=av.vocab_size,
                           compute_dtype=args.compute_dtype)
    print(f"loaded epoch {state['epoch']} from {exp_dir}")
    if arch is not None:
        print("genotype:", search.genotype(arch, mcfg.darts_steps,
                                           mcfg.darts_multiplier))
    elif mcfg.arch_type == "derived":
        print("genotype:", mcfg.genotype)

    def images(batch):
        return pipeline.normalize_images(
            torch.from_numpy(batch["image_u8"]).to(device))

    total_corr = n = n_batches = 0
    total_b4 = 0.0
    batches = itertools.islice(pipeline.epoch_batches(
        val, args.batch_size, np.random.default_rng(0), shuffle=False),
        args.num_batches)
    with torch.no_grad():
        for bi, batch in enumerate(batches):
            img = images(batch)
            qst = torch.from_numpy(batch["question"]).to(device)
            mc = torch.from_numpy(batch["answer_multi_choice"]).to(device)
            ans_logits, _ = vqa_ef.ef_forward(ef_params, arch, mcfg, img,
                                              qst)
            pred = ans_logits.argmax(1)
            total_corr += int(num_correct(mask_unk(pred, av.unk2idx), mc))
            gen_det, gen_ans = vqa_ef.ef_generate(ef_params, arch, mcfg, img)
            gen_det = gen_det.cpu().numpy()
            gen_pred = gen_ans.argmax(1).cpu().numpy()
            n += len(batch["image_u8"])
            n_batches += 1
            names = val.image_names(batch["index"])
            total_b4 += calc_bleu_scores(names, gen_det, qv, vqa_struct)
            if bi == 0:
                gen_sto, _ = vqa_ef.ef_generate(
                    ef_params, arch, mcfg, img, sample_deterministic=False,
                    sample_gen=torch.Generator(device=device).manual_seed(1),
                    temperature=args.temperature)
                gen_sto = gen_sto.cpu().numpy()
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
    acc, bleu4 = total_corr / n, total_b4 / n_batches
    print(f"\nval multi-choice acc (unk-masked): {acc:.4f} over {n} items; "
          f"BLEU4 {bleu4:.2f}")
    return {"acc": acc, "bleu4": bleu4, "n": n}


if __name__ == "__main__":
    main()
