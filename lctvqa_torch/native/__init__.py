"""The C++ data-loader core (the port's counterpart of lctvqa/native).

Batch assembly's host-side work has a C++ implementation in
`src/native.cpp`, loaded with ctypes: the image and answer row gathers,
split over `num_threads` threads (the loader's `num_workers`), the draw of
one valid answer per item (splitmix64 from one seed a batch) with the
multi-choice rows, and the tokenizer. It computes what the JAX package's
core computes, bit for bit, so the port's loader gives the JAX loader's
batches for the same seed.

The library is built at the first use (`build.py`, into `build/native/`
at the repo root), never loaded from the JAX package. `available()`
builds and loads it and returns True, or raises with the compiler's
error: nothing falls back to numpy. `python -m lctvqa_torch.native.build`
builds it ahead of time.

`sample_answers_plain` and `gather_rows_plain` are the plain versions
(Python integers and numpy), which the tests and chip_smoke.py hold the
core to.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_PTR = ctypes.c_void_p  # an array's data pointer, `a.ctypes.data`
_MASK64 = (1 << 64) - 1
SEED_MIX = 0xA0761D6478BD642F


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            from lctvqa_torch.native.build import build

            lib = ctypes.CDLL(str(build()))
            lib.lct_tokenize.restype = ctypes.c_int
            lib.lct_tokenize.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_int]
            lib.lct_sample_answers.restype = None
            lib.lct_sample_answers.argtypes = [
                _PTR, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_uint64, _PTR, _PTR, ctypes.c_int]
            lib.lct_gather_rows.restype = None
            lib.lct_gather_rows.argtypes = [
                _PTR, _PTR, ctypes.c_int, ctypes.c_longlong, _PTR,
                ctypes.c_int]
            _lib = lib
    return _lib


def available() -> bool:
    """Build (at the first call) and load the core; True. Raises
    RuntimeError naming the compiler's error where it cannot be built."""
    _load()
    return True


def _u8_table(a: np.ndarray, what: str) -> np.ndarray:
    if a.dtype != np.uint8 or not a.flags.c_contiguous or a.ndim < 1:
        raise ValueError(f"{what} must be a C-contiguous uint8 array, got "
                         f"{a.dtype} {a.shape}")
    return a


def tokenize(sentence: str) -> List[str]:
    """lctvqa_torch.text.tokenize in C++; the same tokens for ASCII text
    (bytes >= 0x80 are word characters here, see src/native.cpp)."""
    raw = sentence.encode("utf-8")
    out = ctypes.create_string_buffer(2 * len(raw) + 16)
    n = _load().lct_tokenize(raw, out, len(out))
    if n < 0:
        raise RuntimeError("lct_tokenize: output buffer overflow")
    s = out.value.decode("utf-8")
    return s.split("\n") if s else []


def sample_answers(enc_ans: np.ndarray, unk_idx: int, seed: int,
                   max_num_ans: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """enc_ans uint8 [B, A] -> (answer_label int32 [B], multi_choice int32
    [B, max_num_ans]): each label the (r % n_valid)-th valid column for
    the item's splitmix64 draw r (unk_idx where none is valid), each
    multi-choice row the first valid columns, -1 padded."""
    enc_ans = _u8_table(enc_ans, "enc_ans")
    if enc_ans.ndim != 2 or max_num_ans < 0:
        raise ValueError(f"enc_ans must be [B, A] and max_num_ans >= 0, got "
                         f"{enc_ans.shape} and {max_num_ans}")
    b, a = enc_ans.shape
    labels = np.empty(b, np.int32)
    mc = np.empty((b, max_num_ans), np.int32)
    _load().lct_sample_answers(enc_ans.ctypes.data, b, a, unk_idx,
                               seed & _MASK64, labels.ctypes.data,
                               mc.ctypes.data, max_num_ans)
    return labels, mc


def gather_rows(src: np.ndarray, rows: np.ndarray,
                num_threads: int = 1) -> np.ndarray:
    """dst[i] = src[rows[i]] for a C-contiguous uint8 `src` of any
    trailing shape; `num_threads` > 1 splits a copy of 1 MiB or more over
    that many C++ threads. Rows outside [0, len(src)) raise IndexError."""
    src = _u8_table(src, "src")
    rows = np.ascontiguousarray(rows, np.int32)
    if rows.ndim != 1:
        raise ValueError(f"rows must be 1-D, got {rows.shape}")
    if len(rows) and (rows.min() < 0 or rows.max() >= len(src)):
        raise IndexError(f"rows out of [0, {len(src)}): {rows.min()}.."
                         f"{rows.max()}")
    item_bytes = int(np.prod(src.shape[1:], dtype=np.int64))
    dst = np.empty((len(rows),) + src.shape[1:], np.uint8)
    _load().lct_gather_rows(src.ctypes.data, rows.ctypes.data, len(rows),
                            item_bytes, dst.ctypes.data, int(num_threads))
    return dst


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def splitmix64(state: int) -> Tuple[int, int]:
    """One splitmix64 step on a Python int: -> (new state, draw)."""
    state = (state + 0x9E3779B97F4A7C15) & _MASK64
    z = ((state ^ (state >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return state, z ^ (z >> 31)


def sample_answers_plain(enc_ans: np.ndarray, unk_idx: int, seed: int,
                         max_num_ans: int = 10
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """`sample_answers` in Python and numpy."""
    b = enc_ans.shape[0]
    labels = np.full(b, unk_idx, np.int32)
    mc = np.full((b, max_num_ans), -1, np.int32)
    state = (seed & _MASK64) ^ SEED_MIX
    for i in range(b):
        valid = np.flatnonzero(enc_ans[i] > 0)
        mc[i, :min(len(valid), max_num_ans)] = valid[:max_num_ans]
        if len(valid):
            state, r = splitmix64(state)
            labels[i] = valid[r % len(valid)]
    return labels, mc


def gather_rows_plain(src: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """`gather_rows` as numpy fancy indexing."""
    return src[np.asarray(rows)]
