"""Offline preprocessing CLI: from the VQA v2 jsons and COCO JPEGs to the
files `python -m lctvqa_torch.main` reads (the port's counterpart of
lctvqa/data/build.py, the same subcommands, flags and files):

    python -m lctvqa_torch.data.build vocab     --input_dir data/vqa --output_dir data/vqa/hdf5_64
    python -m lctvqa_torch.data.build images_h5 --train_dir data/vqa/train2014 --val_dir data/vqa/val2014 --output_dir data/vqa/hdf5_64 --size 64
    python -m lctvqa_torch.data.build qa_h5     --input_dir data/vqa --output_dir data/vqa/hdf5_64
    python -m lctvqa_torch.data.build npy       --input_dir data/vqa --image_dir data/vqa/Resized_Images224 --output_dir data/vqa/hdf5_64
    python -m lctvqa_torch.data.build resize    --input_dir data/vqa/Images --output_dir data/vqa/Resized_Images224 --size 224
    python -m lctvqa_torch.data.build synthetic --output_dir data/vqa/synth

`vocab` writes vocab_questions.txt, vocab_answers.txt and
vocab_unified.txt, which `qa_h5` and `npy` read from their output
directory. `images_h5`, `qa_h5`, `resize` and `synthetic` need h5py or
PIL and raise ImportError naming the one that is missing; `vocab` and
`npy` need neither.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="lctvqa_torch offline data "
                                "builders")
    sub = p.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("vocab")
    v.add_argument("--input_dir", required=True,
                   help="dir containing Questions/ and Annotations/")
    v.add_argument("--output_dir", required=True)
    v.add_argument("--n_answers", type=int, default=1000)

    ih = sub.add_parser("images_h5")
    ih.add_argument("--train_dir", required=True)
    ih.add_argument("--val_dir", required=True)
    ih.add_argument("--output_dir", required=True)
    ih.add_argument("--size", type=int, default=64)

    qh = sub.add_parser("qa_h5")
    qh.add_argument("--input_dir", required=True)
    qh.add_argument("--output_dir", required=True)

    np_ = sub.add_parser("npy")
    np_.add_argument("--input_dir", required=True)
    np_.add_argument("--image_dir", required=True)
    np_.add_argument("--output_dir", required=True)

    rz = sub.add_parser("resize")
    rz.add_argument("--input_dir", required=True)
    rz.add_argument("--output_dir", required=True)
    rz.add_argument("--size", type=int, default=224)

    sy = sub.add_parser("synthetic")
    sy.add_argument("--output_dir", required=True)
    sy.add_argument("--num_images", type=int, default=8)
    sy.add_argument("--num_questions", type=int, default=24)
    sy.add_argument("--img_size", type=int, default=64)
    sy.add_argument("--n_answers", type=int, default=16)

    args = p.parse_args(argv)
    if args.cmd == "vocab":
        from lctvqa_torch.data import vocab
        os.makedirs(args.output_dir, exist_ok=True)
        vocab.make_vocab_questions(
            os.path.join(args.input_dir, "Questions"),
            os.path.join(args.output_dir, "vocab_questions.txt"))
        vocab.make_vocab_answers(
            os.path.join(args.input_dir, "Annotations"),
            os.path.join(args.output_dir, "vocab_answers.txt"),
            n_answers=args.n_answers)
        vocab.make_vocab_unified(
            os.path.join(args.input_dir, "Questions"),
            os.path.join(args.input_dir, "Annotations"),
            os.path.join(args.output_dir, "vocab_unified.txt"),
            n_answers=args.n_answers)
    elif args.cmd == "images_h5":
        from lctvqa_torch.data.preprocess import build_images_h5
        build_images_h5({"train": args.train_dir, "val": args.val_dir},
                        args.output_dir, size=args.size)
    elif args.cmd == "qa_h5":
        from lctvqa_torch.data.preprocess import build_qa_h5
        build_qa_h5(args.input_dir, args.output_dir)
    elif args.cmd == "npy":
        from lctvqa_torch.data.preprocess import build_npy_inputs
        build_npy_inputs(args.input_dir, args.image_dir, args.output_dir)
    elif args.cmd == "resize":
        from lctvqa_torch.data.preprocess import resize_images_dir
        n = resize_images_dir(args.input_dir, args.output_dir, args.size)
        print(f"resized {n} images")
    elif args.cmd == "synthetic":
        from lctvqa_torch.data.synthetic import make_dataset
        make_dataset(args.output_dir, num_images=args.num_images,
                     num_questions=args.num_questions,
                     img_size=args.img_size, n_answers=args.n_answers)
        print(f"synthetic dataset at {args.output_dir}")


if __name__ == "__main__":
    main()
