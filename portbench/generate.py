"""The general traffic generator: what a traffic mix's parameters (a JSON
file under `portbench/traffic/`) describe, drawn from `--seed`.

- `qa_set`: a VQA split in host RAM, the arrays the program's loader
  (`pipeline.loader_from_arrays`) reads: random uint8 images, questions
  of `<start>`, a drawn number of words and `<end>`, zero-padded to the
  model's length, and ten human answers each, seven in ten of them the
  item's main answer.
- `arrivals`: an open loop's due times, Poisson at a fixed rate.

Every seed gives the same amount of work: the sizes come from the mix,
the seed only fills them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

META = ("<pad>", "<unk>", "<start>", "<end>")


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator of its own for each use of one seed."""
    return np.random.default_rng([seed & (2 ** 64 - 1), stream])


def stream(seed: int, n: int) -> int:
    """A torch generator's seed for the n-th use of one seed."""
    return (seed * 1_000_003 + n) % (2 ** 63)


def vocabularies(qst_vocab_size: int, ans_vocab_size: int):
    """Word lists of the model's sizes: the four meta tokens then words
    (questions), `<unk>` then answers."""
    qst = list(META) + [f"w{i}" for i in range(qst_vocab_size - len(META))]
    ans = ["<unk>"] + [f"a{i}" for i in range(ans_vocab_size - 1)]
    return qst, ans


def question_lengths(g: np.random.Generator, n: int,
                     pmf: Dict[str, float]) -> np.ndarray:
    """Numbers of words drawn from `pmf` ({"3": p, ...})."""
    sizes = np.array([int(k) for k in pmf])
    p = np.array([float(v) for v in pmf.values()])
    return g.choice(sizes, size=n, p=p / p.sum())


def questions(g: np.random.Generator, n: int, max_len: int, vocab: int,
              pmf: Dict[str, float]) -> np.ndarray:
    """[n, max_len] int32: `<start>`, words, `<end>`, zeros."""
    lens = question_lengths(g, n, pmf)
    if lens.max() + 2 > max_len:
        raise ValueError(f"a question of {lens.max()} words does not fit "
                         f"{max_len} tokens")
    out = np.zeros((n, max_len), np.int32)
    out[:, 0] = META.index("<start>")
    words = g.integers(len(META), vocab, (n, max_len)).astype(np.int32)
    cols = np.arange(max_len)[None, :]
    body = (cols >= 1) & (cols <= lens[:, None])
    out[body] = words[body]
    out[np.arange(n), lens + 1] = META.index("<end>")
    return out


def images(g: np.random.Generator, n: int, size: int) -> np.ndarray:
    return np.frombuffer(g.bytes(n * size * size * 3), np.uint8).reshape(
        n, size, size, 3)


def qa_set(seed: int, mix: dict, m: dict) -> Dict[str, object]:
    """{"train": split, "val": split, "qst_words", "ans_words"}, each
    split {enc_qst, qst_len, enc_ans, img_id, images, coco_ids}."""
    qst_words, ans_words = vocabularies(m["qst_vocab_size"],
                                        m["ans_vocab_size"])
    out: Dict[str, object] = {"qst_words": qst_words, "ans_words": ans_words}
    n_ans = m["ans_vocab_size"]
    for s, split in enumerate(("train", "val")):
        g = rng(seed, 10 + s)
        nq, ni = mix[f"{split}_questions"], mix[f"{split}_images"]
        enc = questions(g, nq, m["max_qst_len"], m["qst_vocab_size"],
                        mix["words_pmf"])
        main = g.integers(1, n_ans, nq)
        picks = np.where(g.random((nq, 10)) < 0.7, main[:, None],
                         g.integers(1, n_ans, (nq, 10)))
        enc_ans = np.zeros((nq, n_ans), np.uint8)
        np.add.at(enc_ans, (np.repeat(np.arange(nq), 10), picks.ravel()), 1)
        base = 1000 * (s + 1)
        out[split] = {
            "enc_qst": enc, "qst_len": (enc > 0).sum(1).astype(np.int32),
            "enc_ans": enc_ans,
            "img_id": (base + g.permutation(np.arange(nq) % ni)).astype(
                np.int32),
            "images": images(g, ni, m["img_size"]),
            "coco_ids": np.arange(base, base + ni, dtype=np.int64)}
    return out


def answer_batches(seed: int, mix: dict, m: dict) -> List[dict]:
    """`mix["distinct_batches"]` batches of `mix["batch"]` image and
    question rows, uint8 [B, S, S, 3] and int32 [B, T]."""
    g = rng(seed, 20)
    b = mix["batch"]
    out = []
    for _ in range(mix["distinct_batches"]):
        out.append({"image_u8": images(g, b, m["img_size"]),
                    "question": questions(g, b, m["max_qst_len"],
                                          m["qst_vocab_size"],
                                          mix["words_pmf"])})
    return out


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of a Poisson stream."""
    g = rng(seed, 30)
    n = int(rate * seconds * 1.2 + 100)
    t = np.cumsum(g.exponential(1.0 / rate, n))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(g.exponential(1.0 / rate,
                                                              n))])
    return t[t < seconds]
