"""Offline preprocessing: images.h5, qst-ans.h5 and the npy records (the
port's own copy of lctvqa/data/preprocess.py, the same files for the same
inputs).

Semantics follow the reference's scripts, since answer accuracy depends
on the same normalization:
- questions: lowercase, the trailing '?' dropped, split on spaces;
- answers: the VQA evaluation's punctuation scheme;
- question encoding: <start> + tokens + <end>, length 25, <pad> = 0;
- answer encoding: each question's count vector over the answer
  vocabulary;
- npy records: the tokenized question and the answers in the vocabulary
  (['<unk>'] where none is).

h5py and PIL are imported inside the functions that need them: the npy
records need neither, and a machine without them (the card's) still
builds those.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from lctvqa_torch.text import VocabDict, tokenize

MAX_QST_LEN_H5 = 25

# the answer normalization's regexes (the VQA evaluation script's)
_period_strip = re.compile(r"(?!<=\d)(\.)(?!\d)")
_comma_strip = re.compile(r"(\d)(,)(\d)")
_punctuation_chars = re.escape(r';/[]"{}()=+\_-><@`,?!')
_punctuation = re.compile(r"([{}])".format(re.escape(_punctuation_chars)))
_punctuation_with_a_space = re.compile(
    r"(?<= )([{0}])|([{0}])(?= )".format(_punctuation_chars))


def process_punctuation(s: str) -> str:
    """The VQA evaluation's answer normalization; its odd bits are the
    original script's on purpose."""
    if _punctuation.search(s) is None:
        return s
    s = _punctuation_with_a_space.sub("", s)
    if _comma_strip.search(s) is not None:
        s = s.replace(",", "")
    s = _punctuation.sub(" ", s)
    s = _period_strip.sub("", s)
    return s.strip()


def prepare_questions(questions_json: dict):
    """Yield (tokens, image_id): lowercase, the last character ('?')
    dropped, split on single spaces."""
    for q in questions_json["questions"]:
        question = q["question"].lower()[:-1]
        yield question.split(" "), q["image_id"]


def prepare_answers(answers_json: dict):
    for ann in answers_json["annotations"]:
        yield [process_punctuation(a["answer"]) for a in ann["answers"]]


def encode_question(question: Sequence[str], token_to_index: Dict[str, int],
                    max_question_length: int = MAX_QST_LEN_H5
                    ) -> Tuple[np.ndarray, int]:
    """<start> tok... <end>, zero-padded; -> (vec, len(question) + 1)."""
    if len(question) > max_question_length - 2:
        raise ValueError(f"a question of {len(question)} tokens does not "
                         f"fit {max_question_length} with <start>, <end>")
    vec = np.zeros(max_question_length, np.int64)
    vec[0] = token_to_index["<start>"]
    i = -1
    for i, token in enumerate(question):
        vec[i + 1] = token_to_index.get(token, 0)
    vec[i + 2] = token_to_index["<end>"]
    return vec, len(question) + 1


def encode_answers(answers: Sequence[str],
                   answer_to_index: Dict[str, int]) -> np.ndarray:
    vec = np.zeros(len(answer_to_index), np.uint8)
    for a in answers:
        idx = answer_to_index.get(a)
        if idx is not None:
            vec[idx] += 1
    return vec


def check_integrity(questions: dict, answers: dict) -> None:
    """Raises unless the questions and annotations are aligned one to
    one, by question id and by image id."""
    pairs = list(zip(questions["questions"], answers["annotations"]))
    if not all(q["question_id"] == a["question_id"] for q, a in pairs):
        raise ValueError("Questions not aligned with answers")
    if not all(q["image_id"] == a["image_id"] for q, a in pairs):
        raise ValueError("Image id of question and answer don't match")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _questions_path(input_dir: str, split: str) -> str:
    return os.path.join(input_dir, "Questions",
                        f"v2_OpenEnded_mscoco_{split}_questions.json")


def _annotations_path(input_dir: str, split: str) -> str:
    return os.path.join(input_dir, "Annotations",
                        f"v2_mscoco_{split}_annotations.json")


def build_qa_h5(input_dir: str, output_dir: str,
                splits: Iterable[str] = ("train2014", "val2014"),
                max_qst_len: int = MAX_QST_LEN_H5) -> str:
    """Write qst-ans.h5 with {split}/{enc_qst,qst_len,enc_ans,img_id},
    from the vocabularies already in `output_dir`."""
    import h5py

    os.makedirs(output_dir, exist_ok=True)
    out_file = os.path.join(output_dir, "qst-ans.h5")
    vocab_qst = VocabDict(os.path.join(output_dir, "vocab_questions.txt"))
    vocab_ans = VocabDict(os.path.join(output_dir, "vocab_answers.txt"))
    if vocab_qst.word2idx_dict.get("<pad>") != 0:
        raise ValueError("the question vocabulary's <pad> is not index 0")

    with h5py.File(out_file, "w", libver="latest") as fd:
        for split in splits:
            questions_json = _load_json(_questions_path(input_dir, split))
            answers_json = _load_json(_annotations_path(input_dir, split))
            check_integrity(questions_json, answers_json)
            n = len(questions_json["questions"])
            split_name = ("train" if "train" in split
                          else "val" if "val" in split else "test")
            g = fd.create_group(split_name)
            enc_qst = g.create_dataset("enc_qst", (n, max_qst_len),
                                       dtype=np.int64)
            qst_len = g.create_dataset("qst_len", (n,), dtype=np.uint8)
            enc_ans = g.create_dataset(
                "enc_ans", (n, vocab_ans.vocab_size), dtype=np.uint8)
            img_id = g.create_dataset("img_id", (n,), dtype=np.int32)
            qs = prepare_questions(questions_json)
            ans = prepare_answers(answers_json)
            for i, ((q, iid), a) in enumerate(zip(qs, ans)):
                vec, qlen = encode_question(q, vocab_qst.word2idx_dict,
                                            max_qst_len)
                enc_qst[i] = vec
                qst_len[i] = qlen
                enc_ans[i] = encode_answers(a, vocab_ans.word2idx_dict)
                img_id[i] = iid
    return out_file


def resize_image(img, size: int):
    """A PIL image resized to size x size."""
    return img.resize((size, size))


def build_images_h5(image_dirs: Dict[str, str], output_dir: str,
                    size: int = 64) -> str:
    """Write images.h5 with {split}/{images uint8 NHWC, coco_ids}.
    image_dirs maps a split name ('train'/'val') to a directory of COCO
    jpgs, read in sorted order. Files that do not decode, or whose name
    holds no 12-digit id, are skipped with a message, and the datasets
    cut to the images kept: they are chunked, an image a chunk, so that
    they can be cut (the JAX package's builder writes contiguous ones,
    which h5py cannot resize, and fails where it skips a file)."""
    import h5py
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    out_file = os.path.join(output_dir, "images.h5")
    id_re = re.compile(r"_(\d{12})\.jpg$")
    with h5py.File(out_file, "w", libver="latest") as fd:
        for split, d in image_dirs.items():
            names = sorted(n for n in os.listdir(d) if n.endswith(".jpg"))
            g = fd.create_group(split)
            images = g.create_dataset(
                "images", (len(names), size, size, 3), dtype=np.uint8,
                maxshape=(None, size, size, 3), chunks=(1, size, size, 3))
            ids = g.create_dataset("coco_ids", (len(names),), dtype=np.int64,
                                   maxshape=(None,))
            kept = 0
            for name in names:
                try:
                    img = Image.open(os.path.join(d, name)).convert("RGB")
                    images[kept] = np.asarray(resize_image(img, size))
                    ids[kept] = int(id_re.search(name).group(1))
                    kept += 1
                except (IOError, OSError, AttributeError) as e:
                    print(f"skipping corrupt image {name}: {e}")
            if kept < len(names):
                images.resize((kept, size, size, 3))
                ids.resize((kept,))
    return out_file


def resize_images_dir(input_dir: str, output_dir: str,
                      size: int = 224) -> int:
    """Every JPEG or PNG under `input_dir` resized into the same tree
    under `output_dir` (for the npy loader); files that do not decode are
    skipped with a message. -> the number of images written."""
    from PIL import Image

    count = 0
    for root, _dirs, files in os.walk(input_dir):
        rel = os.path.relpath(root, input_dir)
        out_root = os.path.join(output_dir, rel)
        os.makedirs(out_root, exist_ok=True)
        for name in files:
            if not name.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            try:
                with Image.open(os.path.join(root, name)) as img:
                    img = img.convert("RGB").resize((size, size))
                    img.save(os.path.join(out_root, name))
                count += 1
            except (IOError, OSError) as e:
                print(f"skipping corrupt image {name}: {e}")
    return count


def build_npy_inputs(input_dir: str, image_dir: str, output_dir: str,
                     splits: Sequence[str] = ("train2014", "val2014")
                     ) -> None:
    """The npy records: per question a dict of image name and path,
    question id, string and tokens, and for train and val all answers
    and those in `output_dir`'s answer vocabulary, ['<unk>'] where none
    is."""
    ans_vocab = VocabDict(os.path.join(output_dir, "vocab_answers.txt"))
    valid_answer_set = set(ans_vocab.word_list)
    out_names = {"train2014": "train.npy", "val2014": "valid.npy",
                 "test2015": "test.npy", "test-dev2015": "test-dev.npy"}
    for split in splits:
        questions = _load_json(_questions_path(input_dir, split))["questions"]
        load_answer = split in ("train2014", "val2014")
        qid2ann = {}
        if load_answer:
            anns = _load_json(_annotations_path(input_dir,
                                                split))["annotations"]
            qid2ann = {a["question_id"]: a for a in anns}
        coco_set = split.replace("-dev", "")
        records = []
        for q in questions:
            image_name = f"COCO_{coco_set}_{q['image_id']:012d}"
            rec = dict(
                image_name=image_name,
                image_path=os.path.join(os.path.abspath(image_dir),
                                        coco_set, image_name + ".jpg"),
                question_id=q["question_id"],
                question_str=q["question"],
                question_tokens=tokenize(q["question"]),
            )
            if load_answer:
                ann = qid2ann[q["question_id"]]
                all_answers = [a["answer"] for a in ann["answers"]]
                valid = [a for a in all_answers if a in valid_answer_set]
                rec["all_answers"] = all_answers
                rec["valid_answers"] = valid if valid else ["<unk>"]
            records.append(rec)
        np.save(os.path.join(output_dir, out_names.get(split, split)),
                np.array(records, dtype=object))
