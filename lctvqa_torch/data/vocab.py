"""Offline vocabulary builders (the port's own copy of
lctvqa/data/vocab.py).

From the raw VQA jsons: the question vocabulary is the sorted unique
tokens behind `<pad>`, `<unk>`, `<start>`, `<end>` (indices 0-3); the
answer vocabulary is `<unk>` and the n - 1 most frequent answers that
hold no punctuation; the unified vocabulary merges both (answers split
into words) and puts `<sep>` fifth, at index 4. The files are one word
per line, byte for byte the JAX package's for the same jsons.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Set

from lctvqa_torch.text import tokenize

_NON_WORD = re.compile(r"[^\w\s]")


def _iter_json_files(input_dir: str) -> Iterable[str]:
    for name in sorted(os.listdir(input_dir)):
        yield os.path.join(input_dir, name)


def _question_words(question_dir: str) -> Set[str]:
    words: Set[str] = set()
    for path in _iter_json_files(question_dir):
        with open(path) as f:
            for q in json.load(f)["questions"]:
                words.update(tokenize(q["question"]))
    return words


def ranked_answers(annotation_dir: str) -> List[str]:
    """Punctuation-free answers, most frequent first (ties in the order
    first seen)."""
    counts: Dict[str, int] = defaultdict(int)
    for path in _iter_json_files(annotation_dir):
        with open(path) as f:
            for ann in json.load(f)["annotations"]:
                for answer in ann["answers"]:
                    if not _NON_WORD.search(answer["answer"]):
                        counts[answer["answer"]] += 1
    return sorted(counts, key=counts.get, reverse=True)


def _write(out_file: str, words: List[str]) -> List[str]:
    with open(out_file, "w") as f:
        f.writelines(w + "\n" for w in words)
    return words


def make_vocab_questions(question_dir: str, out_file: str) -> List[str]:
    return _write(out_file, ["<pad>", "<unk>", "<start>", "<end>"]
                  + sorted(_question_words(question_dir)))


def make_vocab_answers(annotation_dir: str, out_file: str,
                       n_answers: int = 1000) -> List[str]:
    ranked = ranked_answers(annotation_dir)
    if "<unk>" in ranked:
        raise ValueError("an answer of the annotations is '<unk>'")
    return _write(out_file, ["<unk>"] + ranked[:n_answers - 1])


def make_vocab_unified(question_dir: str, annotation_dir: str,
                       out_file: str, n_answers: int = 1000) -> List[str]:
    words = _question_words(question_dir)
    for ans in ranked_answers(annotation_dir)[:n_answers - 1]:
        words.update(ans.split())
    return _write(out_file, ["<pad>", "<unk>", "<start>", "<end>", "<sep>"]
                  + sorted(words))
