"""Text / vocabulary utilities (the port's own copy of lctvqa/text.py).

Semantics match the reference's `utils/text_helper.py:4-54` exactly:
answer-accuracy parity depends on identical tokenization.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Sequence

SENTENCE_SPLIT_REGEX = re.compile(r"(\W+)")

META_TOKENS = ("<start>", "<end>", "<pad>")


def tokenize(sentence: str) -> List[str]:
    """Lowercase and split on non-word runs, dropping empty pieces."""
    tokens = SENTENCE_SPLIT_REGEX.split(sentence.lower())
    return [t.strip() for t in tokens if len(t.strip()) > 0]


def load_str_list(fname: str) -> List[str]:
    with open(fname) as f:
        return [line.strip() for line in f.readlines()]


class VocabDict:
    """Word <-> index dictionary with `<unk>` fallback.

    Mirrors `utils/text_helper.py:20-54`; can be constructed either from a
    vocab file (one word per line) or directly from a word list.
    """

    def __init__(self, vocab_file: str | None = None,
                 word_list: Sequence[str] | None = None):
        if word_list is None:
            assert vocab_file is not None
            word_list = load_str_list(vocab_file)
        self.word_list = list(word_list)
        self.word2idx_dict = {w: i for i, w in enumerate(self.word_list)}
        self.vocab_size = len(self.word_list)
        self.unk2idx = self.word2idx_dict.get("<unk>")

    def idx2word(self, n_w: int) -> str:
        return self.word_list[n_w]

    def word2idx(self, w: str) -> int:
        if w in self.word2idx_dict:
            return self.word2idx_dict[w]
        if self.unk2idx is not None:
            return self.unk2idx
        raise ValueError(
            f"word {w} not in dictionary (and dictionary has no <unk>)")

    def tokenize_and_index(self, sentence: str) -> List[int]:
        return [self.word2idx(w) for w in tokenize(sentence)]

    def arr2qst(self, arr: Iterable[int]) -> str:
        """Convert index array to a question string, stripping meta tokens."""
        words = [self.idx2word(int(i)) for i in arr]
        return " ".join(w for w in words if w not in META_TOKENS)
