"""CLI entry point of the port (counterpart of lctvqa/main.py).

    python -m lctvqa_torch.main --exp my_exp --input_dir ...

Runs the LCT search on the CUDA device: stage 3 (the architecture
update, `--architect_mode`, unless `--skip_stage3`), stage 1 and stage 2
on the EF and W models, then validation; `--device cpu` runs the same
loop on the CPU, for a check. `--arch_type derived --genotype G`
retrains the network of a searched (or preset) genotype instead: stages
1 and 2 and validation, as a derived net has no arch to update.
`--use_old_dataloader` feeds the loop from the npy records instead of
the h5 files. `--package darts` runs the 2-stage DARTS loop
(train/experiment_darts.py; `--qst_only` drops the answer loss) and
`--package unified` its QA-stream model, both on the npy records. The
flags are the JAX CLI's where they mean something here. Flags of paths
that are not ported raise and name the ROADMAP.md entry that says why.

Data parallelism, one process a GPU (parallel/): `--num_devices N`
starts N ranks on this host (0, the default: one a card, one on the
CPU), NCCL between the cards, gloo with `--device cpu`. Under torchrun
(its environment names the rank and world) each process is one rank;
`--multihost` joins ranks on several hosts through
`--coordinator_address host:port` of rank 0, `--num_processes` (ranks
in all) and `--process_id` (this one's), or through torchrun's
environment where the address is empty. The global batch is
`--batch_size`, split evenly over the ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from lctvqa_torch.config import (Config, DataConfig, MeshConfig,
                                 ModelConfig, TrainConfig)

# flag -> where ROADMAP.md queues it
NOT_PORTED = {
    "fuse_mixed_ops": "'Not ported' (search_fused.py, a JAX-only way of "
                      "running the supernet)",
    "remat_cells": "'Not ported' (rematerialization of the JAX program)",
    "pack_conv_branches": "'Not ported' (a JAX-only packing of the conv "
                          "branches)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LCT-VQA on PyTorch and CUDA")
    p.add_argument("--w_lambda", type=float, default=1.0)
    p.add_argument("--num_epochs", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--train_portion", type=float, default=1.0)
    p.add_argument("--exp", type=str, default="default_exp")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--input_dir", type=str, default="data/vqa/hdf5_64")
    p.add_argument("--num_workers", type=int, default=8,
                   help="threads of the C++ core that gather a batch's "
                        "image rows (a batch under 1 MiB takes one)")
    p.add_argument("--arch_type", type=str, default="darts",
                   choices=["fixed", "darts", "derived"])
    p.add_argument("--arch_update_freq", type=int, default=2000)
    p.add_argument("--skip_stage2", action="store_true")
    p.add_argument("--skip_stage3", action="store_true")
    p.add_argument("--no_pretrain_enc", action="store_true")
    p.add_argument("--img_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--bn_eval_stats", action="store_true",
                   help="track BN running statistics in training and use "
                        "them in validation")
    p.add_argument("--preload_images", type=str, default="auto",
                   choices=["auto", "ram", "lazy"])
    p.add_argument("--architect_mode", type=str, default="exact-indirect",
                   choices=["exact", "exact-indirect", "fd"])
    p.add_argument("--stage3_remat", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="recompute the architect's inner-unroll forwards in "
                        "its outer backward (torch.utils.checkpoint); "
                        "always on for exact-indirect, as in the JAX CLI")
    p.add_argument("--no_fold_bn", action="store_true",
                   help="explicit per-op BN instead of the folded mixture")
    p.add_argument("--pallas_mixed_op", action="store_true",
                   help="the mixed-op node kernels (ops/cuda_mixedop.py)")
    _m = ModelConfig()
    p.add_argument("--pallas_generate",
                   action=argparse.BooleanOptionalAction,
                   default=_m.pallas_generate,
                   help="the whole-loop greedy decode kernel")
    p.add_argument("--pallas_seq_lstm",
                   action=argparse.BooleanOptionalAction,
                   default=_m.pallas_seq_lstm,
                   help="the whole-sequence LSTM kernels")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--num_devices", type=int, default=0,
                   help="ranks to start on this host, one process a GPU "
                        "(0 = one a card, or one with --device cpu)")
    p.add_argument("--multihost", action="store_true",
                   help="this process is one rank of a group spanning "
                        "hosts (the coordinator flags, or torchrun's "
                        "environment); start one a GPU on every host")
    p.add_argument("--coordinator_address", type=str, default="",
                   help="host:port of rank 0 (multihost; empty = torchrun's "
                        "environment)")
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    p.add_argument("--vgg_weights", type=str, default="",
                   help="path to a torchvision vgg19 state_dict")
    p.add_argument("--tiny", action="store_true",
                   help="shrink the model for a check")
    p.add_argument("--genotype", type=str, default="",
                   help="genotype for --arch_type derived: a preset name "
                        "(e.g. PC_DARTS_cifar, DARTS_V2), a search "
                        "checkpoint path (arch decoded on the spot), or a "
                        "text file with a Genotype(...) repr")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'; nothing falls back")
    p.add_argument("--use_old_dataloader", action="store_true",
                   help="the LCT loop on the npy records "
                        "(data/pipeline_npy.py) instead of the h5 files")
    # experiment family: 'lct' = the 3-stage loop; 'darts' = the 2-stage
    # DARTS loop; 'unified' = its QA-stream variant
    p.add_argument("--package", type=str, default="lct",
                   choices=["lct", "darts", "unified"])
    p.add_argument("--qst_only", action="store_true",
                   help="question-only loss (darts package)")
    # accepted so that they can be refused by name
    for flag in NOT_PORTED:
        p.add_argument(f"--{flag}", action="store_true")
    return p


def check_ported(args) -> None:
    """Raise for every flag whose path the port does not have."""
    for flag, where in NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported: ROADMAP.md, {where}")


def config_from_args(args) -> Config:
    genotype = None
    if args.genotype:
        from lctvqa_torch.genotype import resolve_genotype
        genotype = resolve_genotype(args.genotype)
    model = ModelConfig(arch_type=args.arch_type,
                        pretrained_enc=not args.no_pretrain_enc,
                        img_size=args.img_size,
                        compute_dtype=args.compute_dtype,
                        genotype=genotype,
                        bn_eval_stats=args.bn_eval_stats,
                        fold_bn_mixture=not args.no_fold_bn,
                        pallas_mixed_op=args.pallas_mixed_op,
                        pallas_generate=args.pallas_generate,
                        pallas_seq_lstm=args.pallas_seq_lstm)
    if args.tiny:
        model = dataclasses.replace(
            model, img_embed_size=16, word_embed_size=8,
            lstm_hidden_size=16, max_qst_len=8, darts_init_ch=4,
            darts_layers=1, darts_steps=2, darts_multiplier=2,
            vgg_width_mult=1 / 16, vgg_fc_dim=32)
    if genotype is not None:
        # the cell's shape is the genotype's
        model = dataclasses.replace(
            model, darts_steps=len(genotype.normal) // 2,
            darts_multiplier=len(genotype.normal_concat))
    train = TrainConfig(
        w_lambda=args.w_lambda, num_epochs=args.num_epochs,
        batch_size=args.batch_size, train_portion=args.train_portion,
        arch_update_freq=args.arch_update_freq,
        skip_stage2=args.skip_stage2, skip_stage3=args.skip_stage3,
        seed=args.seed, architect_mode=args.architect_mode,
        stage3_remat=args.stage3_remat,
        report_freq=10 if args.arch_type == "darts" else 100)
    data = DataConfig(input_dir=args.input_dir,
                      num_workers=args.num_workers,
                      use_old_dataloader=args.use_old_dataloader,
                      preload_images=args.preload_images)
    mesh = MeshConfig(num_devices=args.num_devices, multihost=args.multihost)
    return Config(model=model, train=train, data=data, mesh=mesh,
                  exp_name=args.exp, resume=args.resume)


def main(argv=None):
    """Train as the flags say. -> the experiment, or None where this
    command started the ranks as processes of their own."""
    args = build_parser().parse_args(argv)
    check_ported(args)
    cfg = config_from_args(args)
    from lctvqa_torch.models.vqa_ef import check_arch_type
    check_arch_type(cfg.model.arch_type, cfg.model.genotype)
    from lctvqa_torch.parallel import distributed
    outside = distributed.launched() or args.multihost
    n = 1 if outside else distributed.ranks_on_host(args.num_devices,
                                                    args.device)
    if args.pallas_mixed_op and (n > 1 or outside):
        from lctvqa_torch.parallel.mesh import MIXED_OP_UNDER_DP
        raise NotImplementedError("--pallas_mixed_op under data parallelism "
                                  "is not ported: " + MIXED_OP_UNDER_DP)
    join = None
    if args.multihost:
        join = (args.coordinator_address or None, args.num_processes or None,
                args.process_id if args.process_id >= 0 else None)
    return distributed.run_as_ranks(
        _train, list(sys.argv[1:] if argv is None else argv), args.device,
        n, join)


def _train(argv):
    """One rank's run (or the only process's) of the command `argv`."""
    args = build_parser().parse_args(argv)
    return _run(args, config_from_args(args))


def _run(args, cfg: Config):
    """This process's run: one rank of the group, or the only process."""
    # vocab sizes come from the dataset on disk
    from lctvqa_torch.text import VocabDict
    qst_vocab = VocabDict(os.path.join(args.input_dir,
                                       "vocab_questions.txt"))
    ans_vocab = VocabDict(os.path.join(args.input_dir, "vocab_answers.txt"))
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, qst_vocab_size=qst_vocab.vocab_size,
        ans_vocab_size=ans_vocab.vocab_size))

    vgg_params = None
    if args.vgg_weights:
        import torch

        from lctvqa_torch.models.vgg import convert_torch_state_dict
        vgg_params = convert_torch_state_dict(
            torch.load(args.vgg_weights, map_location="cpu",
                       weights_only=True))

    if args.package == "lct":
        from lctvqa_torch.train.experiment import Experiment
        exp = Experiment(cfg, device=args.device, vgg_params=vgg_params)
    elif args.package == "darts":
        from lctvqa_torch.train.experiment_darts import DartsExperiment
        exp = DartsExperiment(cfg, qst_only=args.qst_only,
                              device=args.device)
    else:
        from lctvqa_torch.train.experiment_darts import (
            DartsExperimentUnified)
        exp = DartsExperimentUnified(cfg, device=args.device)
    exp.run()
    return exp


if __name__ == "__main__":
    main()
