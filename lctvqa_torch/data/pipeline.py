"""Input pipeline: a split in host RAM -> batches on the device (port of
lctvqa/data/pipeline.py).

A split's uint8 images live in host RAM (or are read in chunks from the
h5 file). A batch is assembled by the C++ core (lctvqa_torch/native):
the image rows gathered by `num_workers` threads, one answer label drawn
per item from one seed a batch, as the JAX loader does with its core
built; `use_native=False` takes numpy gathers and the generator's own
draws instead, the JAX loader's route without its core. Images cross to
the device as uint8, a quarter of the bytes of fp32, and are normalized
there. A background thread keeps `depth` batches in flight: it pins each
host batch, copies it on a side stream without blocking, and the consumer
waits on the copy's event.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from lctvqa_torch import native
from lctvqa_torch.text import VocabDict
from lctvqa_torch.trace import span

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
DEVICE_KEYS = ("image_u8", "question", "answer_label", "answer_multi_choice")


def normalize_images(u8: torch.Tensor, mean=IMAGENET_MEAN,
                     std=IMAGENET_STD) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized fp32 NHWC, on u8's device."""
    x = u8.to(torch.float32) / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=u8.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=u8.device)
    return (x - mean_t) / std_t


class VqaH5Dataset:
    """One split of the hdf5 dataset: enc_qst/qst_len/enc_ans keyed by
    question, images keyed by coco id, answer_label drawn uniformly from
    the valid answers at every gather, a 10-slot multi_choice padded with
    -1. Built from the two h5 files and the vocab files of `input_dir`,
    or by `from_arrays` from the same fields already in RAM."""

    # above this a split is read from the h5 file in chunks ('auto')
    PRELOAD_LIMIT_BYTES = 4 << 30

    def __init__(self, input_dir: str, split: str,
                 train_portion: float = 1.0, preload: str = "auto"):
        """preload: 'ram' (whole split in host RAM), 'lazy' (chunked h5
        reads per batch) or 'auto' (ram iff the split fits
        PRELOAD_LIMIT_BYTES)."""
        import h5py

        if split not in ("train", "val"):
            raise ValueError(f"unknown split {split!r}")
        if preload not in ("ram", "lazy", "auto"):
            raise ValueError(f"unknown preload mode {preload!r}")
        with h5py.File(os.path.join(input_dir, "qst-ans.h5"), "r") as fd:
            fields = {k: fd[f"{split}/{k}"][()]
                      for k in ("enc_qst", "qst_len", "enc_ans", "img_id")}
        self._img_fd = h5py.File(os.path.join(input_dir, "images.h5"), "r")
        images = self._img_fd[f"{split}/images"]
        fields["coco_ids"] = self._img_fd[f"{split}/coco_ids"][()]
        if preload == "ram" or (preload == "auto" and int(np.prod(
                images.shape)) <= self.PRELOAD_LIMIT_BYTES):
            images = images[()]
            self._img_fd.close()
            self._img_fd = None
        self._setup(split, dict(fields, images=images), VocabDict(
            os.path.join(input_dir, "vocab_questions.txt")), VocabDict(
            os.path.join(input_dir, "vocab_answers.txt")), train_portion)

    @classmethod
    def from_arrays(cls, arrays: dict, split: str,
                    train_portion: float = 1.0) -> "VqaH5Dataset":
        """`arrays`: {split: {enc_qst, qst_len, enc_ans, img_id, images,
        coco_ids}, "qst_words": [...], "ans_words": [...]}, as
        `data.synthetic.make_arrays` returns."""
        self = cls.__new__(cls)
        self._img_fd = None
        self._setup(split, arrays[split],
                    VocabDict(word_list=arrays["qst_words"]),
                    VocabDict(word_list=arrays["ans_words"]), train_portion)
        return self

    def _setup(self, split, fields, qst_vocab, ans_vocab, train_portion):
        self.split = split
        self.enc_qst = np.asarray(fields["enc_qst"]).astype(np.int32)
        self.qst_len = np.asarray(fields["qst_len"]).astype(np.int32)
        self.enc_ans = np.ascontiguousarray(fields["enc_ans"])
        self.img_id = np.asarray(fields["img_id"])
        images = fields["images"]
        self.images = (np.ascontiguousarray(images)
                       if isinstance(images, np.ndarray) else images)
        id_to_row = {int(cid): i for i, cid in enumerate(fields["coco_ids"])}
        self.img_row = np.array([id_to_row[int(i)] for i in self.img_id],
                                np.int32)
        self.qst_vocab, self.ans_vocab = qst_vocab, ans_vocab
        self.num_qst = int(np.floor(train_portion * len(self.enc_qst)))

    def __len__(self):
        return self.num_qst

    def image_names(self, idx: np.ndarray):
        return [f"COCO_{self.split}2014_{int(i):012d}"
                for i in self.img_id[idx]]

    def _gather_images(self, rows: np.ndarray,
                       num_workers: int = 1) -> np.ndarray:
        """Rows of RAM-resident images by the C++ core (`num_workers`
        threads), or of the h5 file in chunks (lazy)."""
        if isinstance(self.images, np.ndarray):
            if native.available():
                return native.gather_rows(self.images, rows,
                                          num_threads=num_workers)
            return self.images[rows]
        # h5 fancy selection needs sorted unique indices
        uniq, inv = np.unique(rows, return_inverse=True)
        return self.images[uniq][inv]

    def gather(self, idx: np.ndarray, rng: np.random.Generator,
               max_num_ans: int = 10, use_native: bool = True,
               num_workers: int = 1) -> Dict[str, np.ndarray]:
        """Vectorized batch assembly for question indices `idx`.

        With `use_native` the C++ core gathers the rows (the images on
        `num_workers` threads) and draws the answer labels by splitmix64
        from one seed, `rng.integers(0, 2**62)`, a batch; without, numpy
        gathers and one `rng.random` draw per item. Either way the
        generator's stream and the labels are the JAX loader's on the same
        route."""
        if use_native and native.available():
            idx = np.ascontiguousarray(idx, np.int32)
            enc_ans = native.gather_rows(self.enc_ans, idx)
            seed = int(rng.integers(0, 2 ** 62))
            labels, mc = native.sample_answers(
                enc_ans, self.ans_vocab.unk2idx, seed, max_num_ans)
            return {
                "image_u8": self._gather_images(self.img_row[idx],
                                                num_workers),
                "question": self.enc_qst[idx],
                "qst_len": self.qst_len[idx],
                "answer_label": labels,
                "answer_multi_choice": mc,
                "index": idx,
            }
        enc_ans = self.enc_ans[idx]                      # [B, A]
        b = enc_ans.shape[0]
        valid = enc_ans > 0
        n_valid = valid.sum(axis=1)                      # [B]
        # a random valid answer per item: uniform among nonzero columns
        u = rng.random(b)
        pick = np.minimum((u * np.maximum(n_valid, 1)).astype(np.int64),
                          np.maximum(n_valid - 1, 0))
        csum = np.cumsum(valid, axis=1)                  # rank of each col
        is_pick = valid & (csum == (pick + 1)[:, None])
        answer_label = np.where(n_valid > 0, is_pick.argmax(axis=1),
                                self.ans_vocab.unk2idx).astype(np.int32)
        # multi-choice: the first max_num_ans valid indices, -1 padded; the
        # answer vocabulary can be narrower than max_num_ans
        order = np.argsort(~valid, axis=1, kind="stable")  # valid cols first
        mc = order[:, :max_num_ans].astype(np.int32)
        if mc.shape[1] < max_num_ans:
            mc = np.pad(mc, ((0, 0), (0, max_num_ans - mc.shape[1])),
                        constant_values=-1)
        mc = np.where(np.arange(max_num_ans)[None, :] < n_valid[:, None],
                      mc, -1)
        return {
            "image_u8": self._gather_images(self.img_row[idx]),
            "question": self.enc_qst[idx],
            "qst_len": self.qst_len[idx],
            "answer_label": answer_label,
            "answer_multi_choice": mc,
            "index": idx.astype(np.int32),
        }


def process_slice(window: np.ndarray, batch_size: int, process_index: int,
                  process_count: int) -> np.ndarray:
    """Rows [r B/W, (r + 1) B/W) of a global batch window, as the JAX
    package's multi-host loader takes them; W must divide B."""
    assert batch_size % process_count == 0, \
        "global batch must divide evenly across hosts"
    per = batch_size // process_count
    return window[process_index * per:(process_index + 1) * per]


def epoch_batches(dataset: VqaH5Dataset, batch_size: int,
                  rng: np.random.Generator, shuffle: bool = True,
                  drop_remainder: bool = True,
                  max_num_ans: int = 10, num_workers: int = 1,
                  process_index: int = 0,
                  process_count: int = 1) -> Iterator[dict]:
    """Host batches of `batch_size` questions, one epoch, each gathered
    with `num_workers` threads. With several ranks every rank draws the
    same shuffled order, and each batch's seed, from the same generator
    and gathers its `batch_size / process_count` rows of each global
    batch (`process_slice`); one process takes the whole batch."""
    assert batch_size % process_count == 0, \
        "global batch must divide evenly across hosts"
    idx = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(idx)
    end = (len(idx) // batch_size * batch_size if drop_remainder
           else len(idx))
    for s in range(0, end, batch_size):
        yield dataset.gather(process_slice(idx[s:s + batch_size], batch_size,
                                           process_index, process_count),
                             rng, max_num_ans, num_workers=num_workers)


def epoch_batches_plain(dataset: VqaH5Dataset, batch_size: int,
                        rng: np.random.Generator,
                        max_num_ans: int = 10) -> Iterator[dict]:
    """The plain version of epoch_batches' native route (shuffled, the
    remainder dropped, one process): the same shuffle and one seed a
    batch from `rng`, the rows gathered by numpy and the labels drawn by
    `native.sample_answers_plain`. For tests and chip_smoke.py, which
    hold the C++ core's batches to it."""
    idx = np.arange(len(dataset))
    rng.shuffle(idx)
    for s in range(0, len(idx) // batch_size * batch_size, batch_size):
        rows = idx[s:s + batch_size].astype(np.int32)
        labels, mc = native.sample_answers_plain(
            dataset.enc_ans[rows], dataset.ans_vocab.unk2idx,
            int(rng.integers(0, 2 ** 62)), max_num_ans)
        yield {"image_u8": native.gather_rows_plain(dataset.images,
                                                    dataset.img_row[rows]),
               "question": dataset.enc_qst[rows],
               "qst_len": dataset.qst_len[rows], "answer_label": labels,
               "answer_multi_choice": mc, "index": rows}


class _WorkerError:
    """Carrier for an exception raised in the prefetch thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Background-thread prefetch of batches onto `device`.

    For a CUDA device the thread pins each host array of `device_keys`
    and copies it with `non_blocking=True` on a side stream; the consumer
    makes its current stream wait on the copy's event, so the copy
    overlaps the step before. Other keys stay numpy arrays on the host.
    An exception in the thread is raised again in the consumer. The
    consumer's `next()` is the span `feed.wait` (`trace.py`)."""

    def __init__(self, it: Iterator[dict], device, depth: int = 2,
                 device_keys=DEVICE_KEYS):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._device = torch.device(device)
        self._device_keys = device_keys
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._run, args=(it,),
                                        daemon=True)
        self._thread.start()

    def _put(self, batch: dict):
        out = dict(batch)
        if self._stream is None:
            for k in self._device_keys:
                if k in out:
                    out[k] = torch.from_numpy(np.ascontiguousarray(out[k]))
            return out, None
        with torch.cuda.stream(self._stream):
            for k in self._device_keys:
                if k in out:
                    host = torch.from_numpy(
                        np.ascontiguousarray(out[k])).pin_memory()
                    out[k] = host.to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _run(self, it):
        try:
            for batch in it:
                self._q.put(self._put(batch))
        except BaseException as exc:  # noqa: BLE001 - re-raised in consumer
            # a swallowed worker error would silently cut the epoch short
            self._q.put(_WorkerError(exc))
            return
        self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        with span("feed.wait"):
            item = self._q.get()
            if item is None:
                raise StopIteration
            if isinstance(item, _WorkerError):
                raise item.exc
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(event)
                for k in self._device_keys:
                    if k in batch:  # allocated on the side stream, used here
                        batch[k].record_stream(stream)
            return batch


def get_loader(input_dir: str, batch_size: int, train_portion: float = 1.0,
               preload: str = "auto") -> Dict[str, VqaH5Dataset]:
    """The two datasets of `input_dir`; iteration is via epoch_batches and
    Prefetcher. Raises if the h5 files cannot be opened."""
    del batch_size  # kept for the JAX package's signature
    return {"train": VqaH5Dataset(input_dir, "train", train_portion, preload),
            "valid": VqaH5Dataset(input_dir, "val", train_portion, preload)}


def loader_from_arrays(arrays: dict,
                       train_portion: float = 1.0) -> Dict[str, VqaH5Dataset]:
    """The same loader dict from arrays already in RAM (for a machine
    without h5py, or data made from a seed)."""
    return {"train": VqaH5Dataset.from_arrays(arrays, "train", train_portion),
            "valid": VqaH5Dataset.from_arrays(arrays, "val", train_portion)}
