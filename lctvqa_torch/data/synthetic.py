"""Synthetic miniature VQA dataset from a seed (the port's counterpart of
lctvqa/data/synthetic.py).

`make_arrays` returns what `VqaH5Dataset` reads, as arrays in RAM: per
split `enc_qst`, `qst_len`, `enc_ans`, `img_id`, `images`, `coco_ids`,
and the two vocabularies as word lists. `make_dataset` writes them in the
on-disk formats of the offline build scripts (`vocab_questions.txt`,
`vocab_answers.txt`, `qst-ans.h5`, `images.h5`), which either package's
loader opens, and beside them `make_npy_records`'s files. Unlike the JAX
package's generator it does not build the h5 files from the raw jsons.

`write_raw_vqa_json` writes the JAX package's raw VQA v2 jsons
(`Questions/`, `Annotations/`), which data/build.py's offline builders
read. `make_npy_records` writes them too, with the unified vocabulary
built from them (`vocab_unified.txt`, data/vocab.py) and the `train.npy`
/ `valid.npy` records, the same files as the JAX package's for the same
seed and sizes; the reference questions of the BLEU4 in validation and eval
(`train/metrics.py::VqaStruct`) come from `valid.npy`. Their image names
are those of the h5 splits' image ids, so the two halves describe the
same images. It needs neither h5py nor an answer vocabulary file, and
writes neither `vocab_questions.txt` nor `vocab_answers.txt`: where only
npy records are made, the caller writes those two with data/vocab.py's
builders from the same jsons.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Optional

import numpy as np

from lctvqa_torch.data import vocab
from lctvqa_torch.text import tokenize

_WORDS = ("what", "is", "the", "color", "of", "cat", "dog", "car", "man",
          "woman", "holding", "many", "how", "where", "red", "blue", "green",
          "ball", "table", "sky")
_ANSWERS = ("yes", "no", "red", "blue", "green", "two", "three", "cat",
            "dog", "white", "black", "1", "2", "frisbee", "tennis")
META = ("<pad>", "<unk>", "<start>", "<end>")
RAW_SPLITS = ("train2014", "val2014")
SPLITS = ("train", "val")


def _vocab(base, size: Optional[int], prefix: str, head) -> list:
    words = list(head) + sorted(base)
    if size is not None:
        words = words[:size]
        words += [f"{prefix}{i}" for i in range(size - len(words))]
    return words


def make_arrays(num_images: int = 8, num_questions: int = 24,
                img_size: int = 16, n_answers: int = 16, seed: int = 0,
                max_qst_len: int = 25,
                qst_vocab_size: Optional[int] = None) -> Dict[str, object]:
    """-> {"train": {...}, "val": {...}, "qst_words": [...], "ans_words":
    [...]}. Questions are `<start>`, 3-6 random words, `<end>`, zero
    padded to `max_qst_len`; each has ten answers, seven in ten of them
    its main answer; images are random uint8, keyed by image id.
    `qst_vocab_size` pads the question vocabulary to a given size (a
    model's full width); `n_answers` is the answer vocabulary's size."""
    rng = np.random.default_rng(seed)
    qst_words = _vocab(_WORDS, qst_vocab_size, "w", META)
    ans_words = _vocab(_ANSWERS, n_answers, "a", ("<unk>",))
    out: Dict[str, object] = {"qst_words": qst_words, "ans_words": ans_words}
    first_word, n_q, n_a = len(META), len(qst_words), len(ans_words)
    for si, split in enumerate(SPLITS):
        base = 1000 * (si + 1)
        enc_qst = np.zeros((num_questions, max_qst_len), np.int32)
        qst_len = np.zeros(num_questions, np.int32)
        enc_ans = np.zeros((num_questions, n_a), np.uint8)
        for i in range(num_questions):
            n = int(rng.integers(3, 7))
            enc_qst[i, 0] = META.index("<start>")
            enc_qst[i, 1:n + 1] = rng.integers(first_word, n_q, n)
            enc_qst[i, n + 1] = META.index("<end>")
            qst_len[i] = n + 1
            main = int(rng.integers(1, n_a))
            # an answer outside the vocabulary (index n_a) counts nowhere
            picks = np.where(rng.random(10) < 0.7, main,
                             rng.integers(1, n_a + 1, 10))
            np.add.at(enc_ans[i], picks[picks < n_a], 1)
        out[split] = {
            "enc_qst": enc_qst, "qst_len": qst_len, "enc_ans": enc_ans,
            "img_id": (base + np.arange(num_questions) % num_images).astype(
                np.int32),
            "images": rng.integers(0, 256, (num_images, img_size, img_size,
                                            3), dtype=np.uint8),
            "coco_ids": np.arange(base, base + num_images, dtype=np.int64),
        }
    return out


def make_dataset(out_dir: str, num_images: int = 8, num_questions: int = 24,
                 img_size: int = 16, n_answers: int = 16, seed: int = 0,
                 **kwargs) -> Dict[str, str]:
    """Write `make_arrays`'s dataset to `out_dir`. Returns {"dir": path}."""
    import h5py

    arrays = make_arrays(num_images, num_questions, img_size, n_answers, seed,
                         **kwargs)
    make_npy_records(out_dir, num_images, num_questions, n_answers, seed)
    for name, key in (("vocab_questions.txt", "qst_words"),
                      ("vocab_answers.txt", "ans_words")):
        with open(os.path.join(out_dir, name), "w") as f:
            f.writelines(w + "\n" for w in arrays[key])
    with h5py.File(os.path.join(out_dir, "qst-ans.h5"), "w") as qa, \
            h5py.File(os.path.join(out_dir, "images.h5"), "w") as im:
        for split in SPLITS:
            data = arrays[split]
            g = qa.create_group(split)
            g.create_dataset("enc_qst", data=data["enc_qst"].astype(np.int64))
            g.create_dataset("qst_len", data=data["qst_len"].astype(np.uint8))
            g.create_dataset("enc_ans", data=data["enc_ans"])
            g.create_dataset("img_id", data=data["img_id"])
            g = im.create_group(split)
            g.create_dataset("images", data=data["images"])
            g.create_dataset("coco_ids", data=data["coco_ids"])
    return {"dir": out_dir}


# ---------------------------------------------------------------------------
# raw VQA jsons and npy records
# ---------------------------------------------------------------------------

def raw_vqa_json(num_images: int = 8, num_questions: int = 24,
                 seed: int = 0) -> Dict[str, tuple]:
    """split -> (questions, annotations) in the VQA v2 schema: per
    question 3-6 random words, ten answers, seven in ten of them its main
    answer."""
    rng = random.Random(seed)
    out = {}
    for si, split in enumerate(RAW_SPLITS):
        questions, annotations = [], []
        img_base = 1000 * (si + 1)
        for qi in range(num_questions):
            image_id = img_base + qi % num_images
            question_id = img_base * 100 + qi
            qwords = rng.sample(_WORDS, rng.randint(3, 6))
            questions.append({
                "question": " ".join(qwords).capitalize() + "?",
                "image_id": image_id,
                "question_id": question_id,
            })
            main_answer = rng.choice(_ANSWERS)
            answers = []
            for ai in range(10):
                a = main_answer if rng.random() < 0.7 else rng.choice(
                    _ANSWERS)
                answers.append({"answer": a, "answer_confidence": "yes",
                                "answer_id": ai + 1})
            annotations.append({
                "question_id": question_id,
                "image_id": image_id,
                "question_type": "what",
                "answer_type": "other",
                "answers": answers,
                "multiple_choice_answer": main_answer,
            })
        out[split] = (questions, annotations)
    return out


def write_raw_vqa_json(out_dir: str, num_images: int = 8,
                       num_questions: int = 24,
                       seed: int = 0) -> Dict[str, tuple]:
    """Write `raw_vqa_json`'s splits as the VQA v2 files,
    `Questions/v2_OpenEnded_mscoco_<split>_questions.json` and
    `Annotations/v2_mscoco_<split>_annotations.json` (the JAX package's
    bytes for the same seed and sizes); -> the splits."""
    raw = raw_vqa_json(num_images, num_questions, seed)
    for split in RAW_SPLITS:
        questions, annotations = raw[split]
        meta = {"data_type": "mscoco", "data_subtype": split}
        for sub, name, key, items in (
                ("Questions", f"v2_OpenEnded_mscoco_{split}_questions.json",
                 "questions", questions),
                ("Annotations", f"v2_mscoco_{split}_annotations.json",
                 "annotations", annotations)):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
            with open(os.path.join(out_dir, sub, name), "w") as f:
                json.dump({**meta, key: items}, f)
    return raw


def make_npy_records(out_dir: str, num_images: int = 8,
                     num_questions: int = 24, n_answers: int = 16,
                     seed: int = 0) -> Dict[str, str]:
    """Write the raw jsons, `vocab_unified.txt` built from them and
    `train.npy` / `valid.npy` (object arrays of one dict per question:
    image name and path, question id, string and tokens, all answers, the
    answers in the vocabulary or ["<unk>"])."""
    raw = write_raw_vqa_json(out_dir, num_images, num_questions, seed)
    questions_dir = os.path.join(out_dir, "Questions")
    annotations_dir = os.path.join(out_dir, "Annotations")
    vocab.make_vocab_unified(questions_dir, annotations_dir,
                             os.path.join(out_dir, "vocab_unified.txt"),
                             n_answers=n_answers)
    # the answer vocabulary of the offline build, not written here
    valid_set = {"<unk>", *vocab.ranked_answers(annotations_dir)[
        :n_answers - 1]}
    for split, out_name in zip(RAW_SPLITS, ("train.npy", "valid.npy")):
        questions, annotations = raw[split]
        anns = {a["question_id"]: a for a in annotations}
        records = []
        for q in questions:
            name = f"COCO_{split}_{q['image_id']:012d}"
            all_answers = [a["answer"]
                           for a in anns[q["question_id"]]["answers"]]
            valid = [a for a in all_answers if a in valid_set]
            records.append(dict(
                image_name=name,
                image_path=os.path.join(out_dir, split, name + ".jpg"),
                question_id=q["question_id"],
                question_str=q["question"],
                question_tokens=tokenize(q["question"]),
                all_answers=all_answers,
                valid_answers=valid if valid else ["<unk>"],
            ))
        np.save(os.path.join(out_dir, out_name),
                np.array(records, dtype=object))
    return {"dir": out_dir}
