"""Metrics (port of lctvqa/train/metrics.py). Device side: multi-choice
correctness and question token-error counts, each a 0-d tensor on the
device of its inputs (nothing reads a value back to the host). Host
side: BLEU4 of generated questions against the reference questions of
the npy records (`VqaStruct`, `calc_bleu_scores`), kept off the step's
path, and the unified model's: BLEU4 of its question-and-answer streams
(`calc_bleu_scores_unified`) and the share of exact answer strings
(`extract_answer`, `unified_ans_acc`). BLEU4 is nltk's `sentence_bleu` with `SmoothingFunction().method1`
(the JAX package's), computed here in plain Python: the port does not
need nltk.
"""

from __future__ import annotations

import math
import os
from collections import Counter, defaultdict
from typing import Sequence

import numpy as np
import torch

from lctvqa_torch.text import extract_answer_words


class VqaStruct:
    """image_name -> [question tokens] (and question + answer, for the
    unified model) reference maps for BLEU, from an npy records file."""

    def __init__(self, input_dir: str, data_file: str = "valid.npy",
                 seed: int = 0):
        self.vqa = np.load(os.path.join(input_dir, data_file),
                           allow_pickle=True)
        self.img_to_qst = defaultdict(list)
        self.img_to_qa = defaultdict(list)
        rng = np.random.RandomState(seed)
        for entry in self.vqa:
            name = entry["image_name"]
            self.img_to_qst[name].append(entry["question_tokens"])
            if "valid_answers" in entry:
                ans = entry["valid_answers"][
                    rng.randint(len(entry["valid_answers"]))]
                self.img_to_qa[name].append(
                    entry["question_tokens"] + ["<sep>", ans])

    def get_ref_qst(self, img_name: str):
        ref = self.img_to_qst[img_name]
        if not ref:
            raise KeyError(f"no reference question for {img_name}")
        return ref

    def get_ref_qa(self, img_name: str):
        ref = self.img_to_qa[img_name]
        if not ref:
            raise KeyError(f"no reference question and answer for "
                           f"{img_name}")
        return ref


def _ngrams(words, n: int) -> Counter:
    return Counter(tuple(words[i:i + n]) for i in range(len(words) - n + 1))


def BLEU4(ref_qst, pred_qst) -> float:
    """100 x sentence BLEU with uniform 4-gram weights and method-1
    smoothing (a precision with no match counts 0.1 matches), as nltk
    computes it: clipped n-gram precisions, the brevity penalty against
    the closest reference length (the shorter on a tie), 0 when no word
    matches."""
    precisions = []
    for n in range(1, 5):
        counts = _ngrams(pred_qst, n)
        best: dict = {}
        for ref in ref_qst:
            ref_counts = _ngrams(ref, n)
            for gram in counts:
                best[gram] = max(best.get(gram, 0), ref_counts[gram])
        matched = sum(min(c, best[g]) for g, c in counts.items())
        total = max(1, sum(counts.values()))
        if n == 1 and matched == 0:
            return 0.0
        precisions.append((matched if matched else 0.1) / total)
    hyp_len = len(pred_qst)
    ref_len = min((len(r) for r in ref_qst),
                  key=lambda n: (abs(n - hyp_len), n))
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / hyp_len)
    return 100 * (bp * math.exp(math.fsum(0.25 * math.log(p)
                                          for p in precisions)))


def calc_bleu_scores(image_names: Sequence[str], pred_qsts, qst_vocab,
                     vqa_struct: VqaStruct) -> float:
    """Mean BLEU4 of generated questions against all reference questions
    of their image. pred_qsts: int array [B, T]."""
    preds = [qst_vocab.arr2qst(np.asarray(q)).split() for q in pred_qsts]
    total = 0.0
    for name, pred in zip(image_names, preds):
        total += BLEU4(vqa_struct.get_ref_qst(name), pred)
    return total / len(image_names)


def calc_bleu_scores_unified(image_names: Sequence[str], pred_qas,
                             unified_vocab, vqa_struct: VqaStruct) -> float:
    """Mean BLEU4 of generated `<start> q <sep> a <end>` streams against
    the reference question-and-answer lists of their image."""
    total = 0.0
    for name, qa in zip(image_names, pred_qas):
        total += BLEU4(vqa_struct.get_ref_qa(name),
                       unified_vocab.arr2qst(np.asarray(qa)).split())
    return total / len(image_names)


def extract_answer(qa_ids, unified_vocab) -> str:
    """The words strictly between `<sep>` and `<end>` of a stream of ids."""
    return extract_answer_words([unified_vocab.word_list[int(i)]
                                 for i in qa_ids])


def unified_ans_acc(qa_gt, qa_pred, unified_vocab) -> float:
    """The share of streams whose answer string is the ground truth's."""
    if len(qa_gt) != len(qa_pred):
        raise ValueError(f"{len(qa_gt)} ground-truth streams against "
                         f"{len(qa_pred)} predicted")
    corr = sum(extract_answer(g, unified_vocab)
               == extract_answer(p, unified_vocab)
               for g, p in zip(qa_gt, qa_pred))
    return corr / len(qa_gt)


def num_correct(pred: torch.Tensor, multi_choice: torch.Tensor) -> torch.Tensor:
    """Count of predictions that match any multi-choice answer. pred [B],
    multi_choice [B, 10] padded with -1."""
    return (multi_choice == pred[:, None]).any(1).sum()


def mask_unk(pred: torch.Tensor, unk_idx: int) -> torch.Tensor:
    """`<unk>` predictions become -9999, so that they match no answer."""
    return torch.where(pred == unk_idx, torch.full_like(pred, -9999), pred)


def num_correct_qst(qst_logits: torch.Tensor, qst: torch.Tensor):
    """(exact, <= 3 errors, <= 5 errors) counts of teacher-forced
    questions."""
    pred = qst_logits.argmax(2)[:, :-1]
    err = (pred != qst[:, 1:]).sum(1)
    return (err == 0).sum(), (err <= 3).sum(), (err <= 5).sum()
