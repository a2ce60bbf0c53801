"""Online serving with the port: the HTTP JSON endpoint of
lctvqa/serve.py over an artifact, run by `lctvqa_torch`.

Endpoints (JSON in, JSON out), as the JAX package's:

- `GET  /healthz`  -> {"ok", "family", "functions"}
- `GET  /meta`     -> artifact meta (word lists replaced by their sizes)
- `POST /answer`   -> {"image_b64"|"image", "question"} -> {"answer"}
                      (W and EF artifacts; a unified artifact's is a 400)
- `POST /generate` -> {"image_b64"|"image"} -> {"question", "answer"}
                      (EF artifacts), {"qa", "answer"} (unified
                      artifacts: the greedy stream without its pads, and
                      its words between <sep> and <end>)

Images: base64 of an encoded image file (decoded and resized via PIL), or
base64 of raw uint8 RGB bytes of exactly img_size*img_size*3, or a nested
uint8 list of shape [img_size, img_size, 3]. Questions are tokenized as
`data/preprocess.encode_question` does (<start> tok... <end>, <pad>=0,
unknown -> 0).

What differs from the JAX package's server is the batcher, the warmup
and the listen backlog:

- `MicroBatcher` fuses concurrent requests into one batched call of the
  port's `ServingModel`, padded to a power-of-two bucket, and copies the
  result to the host once per group.
- Warmup runs every bucket the batcher can dispatch. The JAX package's
  warmup stops at `max_batch` while its batcher pads up to the next power
  of two, so a `max_batch` of 48 dispatches an unwarmed 64; here the two
  share `MicroBatcher.buckets`.
- `VqaHTTPServer` queues up to 1024 pending connections, where
  socketserver's default of 5 lets a burst of concurrent clients be
  dropped or reset.


The batcher pads a group with repeats of its first row, as the JAX
package's does. With a supernet (darts EF) artifact BatchNorm uses the
statistics of the dispatched batch, so an answer depends on the other
requests of its group and on those pad rows: a group of 3 is answered as
the batch of 4 whose last row repeats the first.

A derived-EF artifact does not carry its genotype: `--genotype` names it
(a preset, a search checkpoint or a repr file).

    python -m lctvqa_torch.serve --artifact w.lctx --warmup
    python -m lctvqa_torch.serve --artifact ef_serving.lctx \
        --genotype PC_DARTS_cifar
    python -m lctvqa_torch.serve --artifact unified.lctx

(an artifact of a trained checkpoint: `python -m lctvqa_torch.export`,
or `export.export_state` and `export.save_artifact`). An int8 artifact
(`--int8` there, or the JAX package's) serves with no other flag.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from lctvqa_torch.config import ModelConfig
from lctvqa_torch.export import ServingModel, load_artifact
from lctvqa_torch.text import VocabDict, extract_answer_words, tokenize


def _to_host(out):
    if isinstance(out, tuple):
        return tuple(_to_host(o) for o in out)
    return out.cpu().numpy()


def _row(out, i: int):
    if isinstance(out, tuple):
        return tuple(o[i] for o in out)
    return out[i]


class MicroBatcher:
    """Fuses concurrent single-sample calls into batched model calls.

    `call()` blocks the request thread until its row of the batched result
    is on the host. One dispatcher thread drains the queue: it waits up to
    `window_ms` after the first pending request (skipped when the queue is
    already non-empty), groups by function name, pads each group to its
    bucket with repeats of its first row, and runs one batched call per
    group.
    """

    def __init__(self, model: ServingModel, window_ms: float = 5.0,
                 max_batch: int = 64):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._model = model
        self._window_s = window_ms / 1e3
        self.max_batch = max_batch
        self._q: queue.Queue = queue.Queue()
        self.batch_sizes: list = []  # observed group sizes (stats)
        threading.Thread(target=self._loop, daemon=True).start()

    @staticmethod
    def bucket(n: int) -> int:
        """The padded batch size a group of n requests is dispatched at."""
        return 1 << (n - 1).bit_length()

    @classmethod
    def buckets(cls, max_batch: int) -> List[int]:
        """Every bucket a batcher with this max_batch can dispatch."""
        return [1 << k for k in range(cls.bucket(max_batch).bit_length())]

    def call(self, fn_name: str, *arrays):
        ev = threading.Event()
        slot: Dict[str, Any] = {}
        self._q.put((fn_name, arrays, ev, slot))
        ev.wait()
        if "err" in slot:
            raise RuntimeError(slot["err"])
        return slot["out"]

    def _loop(self):
        while True:
            items = [self._q.get()]
            deadline = time.monotonic() + self._window_s
            while len(items) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0 and self._q.empty():
                    break
                try:
                    items.append(self._q.get(timeout=max(left, 0)))
                except queue.Empty:
                    break
            by_fn: Dict[str, list] = {}
            for it in items:
                by_fn.setdefault(it[0], []).append(it)
            for fn_name, group in by_fn.items():
                self._dispatch(fn_name, group)

    def _dispatch(self, fn_name: str, group: list) -> None:
        n = len(group)
        self.batch_sizes.append(n)
        try:
            b = self.bucket(n)
            args = []
            for k in range(len(group[0][1])):
                rows = [g[1][k] for g in group]
                rows += [rows[0]] * (b - n)
                args.append(np.stack(rows))
            out = _to_host(getattr(self._model, fn_name)(*args))
            for i, (_, _, ev, slot) in enumerate(group):
                slot["out"] = _row(out, i)
                ev.set()
        except Exception as e:  # noqa: BLE001 — report to every waiter
            for _, _, ev, slot in group:
                slot["err"] = f"{type(e).__name__}: {e}"
                ev.set()


class TorchVqaService:
    """Request decoding and response encoding around a ServingModel and
    its MicroBatcher (the JAX package's `VqaService`)."""

    def __init__(self, model: ServingModel, window_ms: float = 5.0,
                 max_batch: int = 64):
        self.model = model
        self.meta = model.meta
        self.batcher = MicroBatcher(model, window_ms, max_batch)
        self._qst_vocab = (VocabDict(word_list=self.meta["qst_words"])
                           if self.meta.get("qst_words") else None)
        self._ans_words = self.meta.get("ans_words")
        self._uni_words = self.meta.get("unified_words")

    # -- input decoding ---------------------------------------------------

    def _decode_image(self, payload: Dict[str, Any]) -> np.ndarray:
        s = self.meta["img_size"]
        if "image_b64" in payload:
            raw = base64.b64decode(payload["image_b64"])
            try:
                from PIL import Image
                im = Image.open(io.BytesIO(raw)).convert("RGB")
                return np.asarray(im.resize((s, s)), np.uint8)
            except Exception:  # noqa: BLE001 - not an image file: raw bytes
                arr = np.frombuffer(raw, np.uint8)
                if arr.size != s * s * 3:
                    raise ValueError(
                        f"raw image must be {s}x{s}x3 uint8 "
                        f"({s * s * 3} bytes), got {arr.size}")
                return arr.reshape(s, s, 3)
        arr = np.asarray(payload["image"], np.uint8)
        if arr.shape != (s, s, 3):
            raise ValueError(f"image must have shape ({s},{s},3), "
                             f"got {arr.shape}")
        return arr

    def _encode_question(self, question: str) -> np.ndarray:
        """<start> tok... <end>, <pad>=0 tail, unknown tokens -> index 0."""
        if self._qst_vocab is None:
            raise ValueError("artifact was exported without --input_dir; "
                             "no question vocab embedded")
        seq = self.meta["max_qst_len"]
        toks = tokenize(question)[:seq - 2]
        vec = np.zeros(seq, np.int32)
        d = self._qst_vocab.word2idx_dict
        vec[0] = d["<start>"]
        for i, t in enumerate(toks):
            vec[i + 1] = d.get(t, 0)
        vec[len(toks) + 1] = d["<end>"]
        return vec

    # -- endpoints --------------------------------------------------------

    def answer(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if "answer_logits" not in self.model.functions:
            raise ValueError("unified artifacts answer via POST /generate")
        u8 = self._decode_image(payload)
        qst = self._encode_question(payload["question"])
        logits = self.batcher.call("answer_logits", u8, qst)
        ans_id = int(np.argmax(logits))
        out = {"answer_id": ans_id}
        if self._ans_words:
            out["answer"] = self._ans_words[ans_id]
        return out

    def generate(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if "generate" not in self.model.functions:
            raise ValueError("W artifacts have no generate function; "
                             "use POST /answer")
        u8 = self._decode_image(payload)
        out = self.batcher.call("generate", u8)
        if self.model.family == "unified":
            if not self._uni_words:
                raise ValueError("no unified vocab embedded in artifact")
            words = [self._uni_words[int(i)] for i in out]
            return {"qa": " ".join(w for w in words if w != "<pad>"),
                    "answer": extract_answer_words(words)}
        tokens, ans_id = out
        res: Dict[str, Any] = {"answer_id": int(ans_id)}
        if self._qst_vocab is not None:
            res["question"] = self._qst_vocab.arr2qst(tokens)
        if self._ans_words:
            res["answer"] = self._ans_words[int(ans_id)]
        return res

    def warmup(self, max_batch: Optional[int] = None) -> int:
        """Run every function at every bucket the batcher can dispatch
        (cuBLAS/cuDNN algorithm choice, kernel build and allocator growth
        then happen before the first request). Returns #calls run."""
        s = self.meta["img_size"]
        seq = self.meta["max_qst_len"]
        n = 0
        for b in MicroBatcher.buckets(max_batch or self.batcher.max_batch):
            u8 = np.zeros((b, s, s, 3), np.uint8)
            args = {"answer_logits": (u8, np.zeros((b, seq), np.int32)),
                    "generate": (u8,)}
            for name in self.model.functions:
                _to_host(getattr(self.model, name)(*args[name]))
                n += 1
        return n

    def healthz(self) -> Dict[str, Any]:
        return {"ok": True, "family": self.meta["family"],
                "functions": self.model.functions,
                "dispatch_batches": len(self.batcher.batch_sizes)}

    def meta_public(self) -> Dict[str, Any]:
        out = dict(self.meta)
        for k in ("qst_words", "ans_words", "unified_words"):
            if k in out:
                out[k.replace("words", "vocab_len")] = len(out.pop(k))
        return out


class _Handler(BaseHTTPRequestHandler):
    service: TorchVqaService  # set on the subclass by make_server

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, obj: Dict[str, Any]):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, self.service.healthz())
        elif self.path == "/meta":
            self._send(200, self.service.meta_public())
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        # The response is computed inside the try and sent after it: the
        # error paths must fire only for service errors, never for a
        # failed socket write of a successful response.
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/answer":
                code, obj = 200, self.service.answer(payload)
            elif self.path == "/generate":
                code, obj = 200, self.service.generate(payload)
            else:
                code, obj = 404, {"error": f"unknown path {self.path}"}
        except (ValueError, KeyError, RuntimeError) as e:
            code, obj = 400, {"error": str(e)}
        except Exception:  # noqa: BLE001 - a 500 body beats a dropped
            # connection; the body is generic, since exception reprs can
            # leak paths and internals
            traceback.print_exc()
            code, obj = 500, {"error": "internal server error"}
        self._send(code, obj)


class VqaHTTPServer(ThreadingHTTPServer):
    """socketserver listens with a backlog of 5. A burst of concurrent
    clients larger than that, arriving while the accept thread waits for
    the GIL, overflows the queue, and a network stack may then reset the
    connections past it. The backlog here holds a full micro-batch
    several times over (the kernel caps it at net.core.somaxconn)."""

    request_queue_size = 1024


def make_server(artifact_path: str, host: str = "127.0.0.1", port: int = 0,
                window_ms: float = 5.0, max_batch: int = 64,
                trusted: bool = False, device: str = "cuda",
                genotype=None, **overrides) -> VqaHTTPServer:
    """Build (but don't start) the HTTP server; `.server_address[1]` is the
    bound port. `genotype` is a derived EF's (export.ServingModel);
    `overrides` are ModelConfig fields (compute_dtype and the kernel
    flags)."""
    model = load_artifact(artifact_path, device=device, trusted=trusted,
                          genotype=genotype, **overrides)
    service = TorchVqaService(model, window_ms=window_ms,
                              max_batch=max_batch)
    handler = type("Handler", (_Handler,), {"service": service})
    return VqaHTTPServer((host, port), handler)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--artifact", type=str, required=True)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--window_ms", type=float, default=5.0,
                   help="micro-batching window after the first pending "
                        "request")
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--warmup", action="store_true",
                   help="run every batch bucket before accepting traffic")
    p.add_argument("--trusted", action="store_true",
                   help="allow loading a LEGACY pickle artifact")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cpu' serves without a GPU (the kernels' plain "
                        "versions)")
    p.add_argument("--compute_dtype", type=str,
                   default=ModelConfig().compute_dtype,
                   choices=("bfloat16", "float32"),
                   help="matmul operand dtype; the artifact does not record "
                        "the one it was trained with")
    p.add_argument("--genotype", type=str, default=None,
                   help="a derived EF artifact's genotype: a preset name, a "
                        "search checkpoint or a Genotype-repr file")
    args = p.parse_args(argv)

    srv = make_server(args.artifact, args.host, args.port, args.window_ms,
                      args.max_batch, trusted=args.trusted,
                      device=args.device, genotype=args.genotype,
                      compute_dtype=args.compute_dtype)
    host, port = srv.server_address[:2]
    svc: TorchVqaService = srv.RequestHandlerClass.service  # type: ignore
    if args.warmup:
        n = svc.warmup()
        print(f"warmup: {n} calls run", flush=True)
    print(f"serving {svc.meta['family']}"
          f"{' int8' if svc.meta.get('int8') else ''} artifact "
          f"({svc.model.functions}) "
          f"on http://{host}:{port} with {torch.device(args.device)}  "
          f"window={args.window_ms}ms max_batch={args.max_batch}",
          flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
