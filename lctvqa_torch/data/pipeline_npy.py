"""The npy-record dataset and the unified QA-stream dataset (the port's
own copy of lctvqa/data/pipeline_npy.py).

A question is `<start>` tokens `<end>`, `<pad>` after, at
`max_qst_length`; the answer label is a random valid answer; the
multi-choice row holds the valid answers, -1 after. The unified dataset
gives one `<start> q <sep> a <end>` stream over `vocab_unified.txt`
instead.

Images come from the JPEG named by a record's `image_path` where it
exists (PIL), else from a table keyed by split and coco id: `images.h5`
(h5py), or the `images` given to the dataset, e.g. `data.synthetic.
make_arrays`' splits ({"train": {"images", "coco_ids"}, "val": ...}),
for a machine without h5py. PIL and h5py are imported only where they
are read. Batches are numpy on the host; the loop moves them to the
device (pipeline.Prefetcher) and normalizes them there.

Two assembly routes draw from the numpy generator as the JAX package's
do, so a seed gives its batches exactly: the vectorized one (every image
from a table) draws the answer choices of a batch in one call, the
per-item one (JPEGs, and always for the unified stream) one draw per
item.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterator, Optional

import numpy as np

from lctvqa_torch.data.pipeline import process_slice
from lctvqa_torch.text import VocabDict

_ID_RE = re.compile(r"_(\d{12})$")
SPLITS = ("train", "val")


def image_table_key(name: str):
    """(split, coco id) of an image name."""
    return ("train" if "train" in name else "val",
            int(_ID_RE.search(name).group(1)))


class VqaNpyDataset:
    """Question/answer view over the npy records."""

    def __init__(self, input_dir: str, input_vqa: str,
                 max_qst_length: int = 30, max_num_ans: int = 10,
                 img_size: int = 64, train_portion: float = 1.0,
                 images: Optional[dict] = None):
        """`images`: split -> {"images" [n, S, S, 3] uint8, "coco_ids"
        [n]}, in place of `input_dir`'s images.h5."""
        self.input_dir = input_dir
        self.vqa = np.load(os.path.join(input_dir, input_vqa),
                           allow_pickle=True)
        self.qst_vocab = VocabDict(
            os.path.join(input_dir, "vocab_questions.txt"))
        self.ans_vocab = VocabDict(
            os.path.join(input_dir, "vocab_answers.txt"))
        self.max_qst_length = max_qst_length
        self.max_num_ans = max_num_ans
        self.img_size = img_size
        self.load_ans = ("valid_answers" in self.vqa[0]
                         and self.vqa[0]["valid_answers"] is not None)
        self._given = images
        self._tables = None  # split -> (images, {coco id: row})
        self._vec = None     # the vectorized route's cache
        self.num_qst = int(np.floor(train_portion * len(self.vqa)))

    def __len__(self):
        return self.num_qst

    def image_names(self, idx: np.ndarray):
        return [self.vqa[int(i)]["image_name"] for i in idx]

    # ---------------- images ----------------
    def _load_tables(self):
        if self._tables is not None:
            return
        if self._given is not None:
            src = {s: (self._given[s]["images"], self._given[s]["coco_ids"])
                   for s in SPLITS if s in self._given}
        else:
            import h5py
            with h5py.File(os.path.join(self.input_dir, "images.h5"),
                           "r") as fd:
                src = {s: (fd[f"{s}/images"][()], fd[f"{s}/coco_ids"][()])
                       for s in fd.keys()}
        self._tables = {s: (np.asarray(imgs), {int(c): i for i, c in
                                               enumerate(ids)})
                        for s, (imgs, ids) in src.items()}

    def _image(self, rec) -> np.ndarray:
        path = rec["image_path"]
        if os.path.exists(path):
            from PIL import Image
            img = Image.open(path).convert("RGB")
            return np.asarray(img.resize((self.img_size, self.img_size)),
                              dtype=np.uint8)
        split, coco_id = image_table_key(rec["image_name"])
        if self._vec is not None:
            return self._vec["imgs"][self._vec["offsets"][split]
                                     + self._vec["ids"][split][coco_id]]
        self._load_tables()
        imgs, ids = self._tables[split]
        return imgs[ids[coco_id]]

    # ---------------- encoding ----------------
    def encode_question(self, rec) -> np.ndarray:
        q = np.full(self.max_qst_length, self.qst_vocab.word2idx("<pad>"),
                    np.int32)
        # cut to fit <start> ... <end>
        toks = rec["question_tokens"][: self.max_qst_length - 2]
        q[0] = self.qst_vocab.word2idx("<start>")
        q[1:len(toks) + 1] = [self.qst_vocab.word2idx(w) for w in toks]
        q[len(toks) + 1] = self.qst_vocab.word2idx("<end>")
        return q

    def item(self, idx: int, rng: np.random.Generator) -> Dict:
        rec = self.vqa[idx]
        sample = {
            "image_u8": self._image(rec),
            "question": self.encode_question(rec),
            "image_name": rec["image_name"],
        }
        if self.load_ans:
            ans_ids = [self.ans_vocab.word2idx(w)
                       for w in rec["valid_answers"]]
            sample["answer_label"] = np.int32(
                ans_ids[rng.integers(len(ans_ids))])
            mc = np.full(self.max_num_ans, -1, np.int32)
            mc[:len(ans_ids)] = ans_ids[:self.max_num_ans]
            sample["answer_multi_choice"] = mc
        return sample

    # ---------------- vectorized batch assembly ----------------
    def _vectorizable(self) -> bool:
        """Whole-batch assembly needs every image from a table; where the
        records' JPEGs exist, assembly is per item."""
        return not os.path.exists(self.vqa[0]["image_path"])

    def _build_vec(self):
        """Encoded questions [n, L], one image table with a row per
        record, and the valid answer ids padded with -1, once."""
        if self._vec is not None:
            return
        self._load_tables()
        n = len(self.vqa)
        q = np.stack([self.encode_question(rec) for rec in self.vqa])
        offsets, parts, off = {}, [], 0
        for s in sorted(self._tables):
            offsets[s] = off
            parts.append(self._tables[s][0])
            off += len(parts[-1])
        imgs = parts[0] if len(parts) == 1 else np.concatenate(parts)
        ids = {s: t[1] for s, t in self._tables.items()}
        rows = np.empty(n, np.int64)
        names = []
        for i, rec in enumerate(self.vqa):
            split, coco_id = image_table_key(rec["image_name"])
            rows[i] = offsets[split] + ids[split][coco_id]
            names.append(rec["image_name"])
        ans_w = counts = None
        if self.load_ans:
            max_c = max(self.max_num_ans,
                        max(len(r["valid_answers"]) for r in self.vqa))
            ans_w = np.full((n, max_c), -1, np.int32)
            counts = np.empty(n, np.int64)
            for i, rec in enumerate(self.vqa):
                a = [self.ans_vocab.word2idx(w) for w in rec["valid_answers"]]
                counts[i] = len(a)
                ans_w[i, :len(a)] = a
        # the combined table replaces the per-split ones
        self._tables = None
        self._vec = dict(q=q, imgs=imgs, rows=rows, names=names,
                         ans_w=ans_w, counts=counts, offsets=offsets, ids=ids)

    def batch_from_indices(self, idx: np.ndarray,
                           rng: np.random.Generator) -> dict:
        self._build_vec()
        v = self._vec
        batch = {
            "image_u8": v["imgs"][v["rows"][idx]],
            "question": v["q"][idx],
            "image_name": [v["names"][int(i)] for i in idx],
            "index": idx.astype(np.int32),
        }
        if self.load_ans:
            choice = rng.integers(0, v["counts"][idx])
            batch["answer_label"] = v["ans_w"][idx, choice].astype(np.int32)
            batch["answer_multi_choice"] = v["ans_w"][idx, :self.max_num_ans]
        return batch

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True, drop_remainder: bool = True,
                process_index: int = 0,
                process_count: int = 1) -> Iterator[dict]:
        """One epoch of batches of `batch_size` records; with several
        ranks each takes its rows of every global batch, as
        `pipeline.epoch_batches` does."""
        assert batch_size % process_count == 0, \
            "global batch must divide evenly across hosts"
        idx = np.arange(len(self))
        if shuffle:
            rng.shuffle(idx)
        n_full = len(idx) // batch_size
        end = n_full * batch_size if drop_remainder else len(idx)
        vec = self._vectorizable()
        for s in range(0, end, batch_size):
            sel = process_slice(idx[s:s + batch_size], batch_size,
                                process_index, process_count)
            if vec:
                yield self.batch_from_indices(sel, rng)
                continue
            items = [self.item(int(i), rng) for i in sel]
            # numpy's scalars include str: image names stack too
            batch = {k: np.stack([it[k] for it in items])
                     if isinstance(items[0][k], (np.ndarray, np.integer))
                     or np.isscalar(items[0][k])
                     else [it[k] for it in items] for k in items[0]}
            batch["index"] = sel.astype(np.int32)
            yield batch


class VqaNpyDatasetUnified(VqaNpyDataset):
    """`<start> q <sep> a <end>` streams over vocab_unified.txt."""

    def __init__(self, input_dir: str, input_vqa: str,
                 max_qst_length: int = 30, max_num_ans: int = 10,
                 img_size: int = 64, train_portion: float = 1.0,
                 images: Optional[dict] = None):
        super().__init__(input_dir, input_vqa, max_qst_length, max_num_ans,
                         img_size, train_portion, images)
        self.unified_vocab = VocabDict(
            os.path.join(input_dir, "vocab_unified.txt"))

    def _vectorizable(self) -> bool:
        # the answer drawn sets where the stream's words go: per item
        return False

    def item(self, idx: int, rng: np.random.Generator) -> Dict:
        rec = self.vqa[idx]
        v = self.unified_vocab
        qa = np.full(self.max_qst_length, v.word2idx("<pad>"), np.int32)
        ans = rec["valid_answers"][rng.integers(
            len(rec["valid_answers"]))].split()
        # the question cut so that <start> q <sep> a <end> fits
        toks = rec["question_tokens"][:max(self.max_qst_length - 3
                                           - len(ans), 0)]
        qlen = len(toks)
        qa[0] = v.word2idx("<start>")
        qa[1:qlen + 1] = [v.word2idx(w) for w in toks]
        qa[qlen + 1] = v.word2idx("<sep>")
        ptr = qlen + 2
        qa[ptr:ptr + len(ans)] = [v.word2idx(w) for w in ans]
        qa[ptr + len(ans)] = v.word2idx("<end>")
        return {"image_u8": self._image(rec), "qa_str": qa,
                "image_name": rec["image_name"]}


def get_npy_loader(input_dir: str, max_qst_length: int = 30,
                   max_num_ans: int = 10, img_size: int = 64,
                   unified: bool = False, train_portion: float = 1.0,
                   images: Optional[dict] = None
                   ) -> Dict[str, VqaNpyDataset]:
    """{"train", "valid"} over `input_dir`'s train.npy and valid.npy;
    `images` as VqaNpyDataset takes it."""
    cls = VqaNpyDatasetUnified if unified else VqaNpyDataset
    return {
        "train": cls(input_dir, "train.npy", max_qst_length, max_num_ans,
                     img_size, train_portion, images),
        "valid": cls(input_dir, "valid.npy", max_qst_length, max_num_ans,
                     img_size, images=images),
    }
