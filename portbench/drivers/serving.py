"""What the serving drivers share: the artifact made in memory from
seeded weights and loaded as the port's `ServingModel`, the closed loop
that keeps calls in flight ahead of the readback, a seeded sample of the
window's calls, and the checks against the plain reference.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from typing import Callable, List

import numpy as np
import torch

from portbench import generate
from portbench.reference import model as R
from portbench.reference import params as P


def family_values(family: str, m: dict, seed: int, device) -> dict:
    """The seeded trees of an artifact of `family` ("w" or "ef")."""
    if family == "w":
        return {"w_params": P.make(P.w_shapes(m), generate.stream(seed, 3),
                                   device)}
    return {"ef_params": P.make(P.ef_shapes(m), generate.stream(seed, 1),
                                device),
            "arch": P.make(P.arch_shapes(m), generate.stream(seed, 2),
                           device)}


def serving_model(config: dict, family: str, seed: int, device,
                  int8: bool = False):
    """The port's ServingModel of an artifact made in memory from the
    seeded weights (`export.export_state`), with the configuration's
    serving flags."""
    from lctvqa_torch import export
    from lctvqa_torch.config import ModelConfig
    from lctvqa_torch.ops import conv

    conv.USE_PALLAS_BN = bool(config.get("bn_kernel", False))
    m = config["model"]
    state = family_values(family, m, seed, device)
    artifact = export.export_state(state, ModelConfig(**m), int8=int8)
    del state
    flags = {k: m[k] for k in ("compute_dtype", "use_pallas_lstm",
                               "pallas_seq_lstm", "pallas_generate",
                               "pallas_mixed_op") if k in m}
    return export.ServingModel(artifact, device, **flags)


class Reservoir:
    """A uniform sample of `k` of a stream's items, drawn from the seed."""

    def __init__(self, seed: int, k: int):
        self.g = generate.rng(seed, 40)
        self.k = k
        self.items: list = []
        self.seen = 0

    def offer(self, item_fn: Callable):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item_fn())
        else:
            j = int(self.g.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item_fn()


def closed_loop(call, batches: List[dict], seconds: float, ahead: int,
                tracer, sample: Reservoir, rows: int, device,
                name: str) -> dict:
    """Calls on the batches in turn, `ahead` dispatched before the oldest
    result is read back to the host; runs until `seconds` have passed,
    then reads back what is in flight. -> counts and the elapsed time."""
    pending = deque()
    done = failed = calls = 0
    t0 = time.perf_counter()

    def retire():
        nonlocal done, failed
        i, out = pending.popleft()
        with tracer.span("readback"):
            host = _host(out)
        ok = all(np.isfinite(h).all() for h in host
                 if np.issubdtype(h.dtype, np.floating))
        done += rows if ok else 0
        failed += 0 if ok else rows
        sample.offer(lambda: (i % len(batches), host))

    while True:
        i = calls
        with tracer.span(name):
            out = call(batches[i % len(batches)])
        pending.append((i, out))
        calls += 1
        tracer.tick()
        if len(pending) > ahead:
            retire()
        if time.perf_counter() - t0 >= seconds and not tracer.pending:
            break
    tracer.close()
    while pending:
        retire()
    elapsed = time.perf_counter() - t0
    return {"seconds": elapsed, "done": done, "failed": failed,
            "calls": calls}


def _host(out) -> tuple:
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(o.cpu().numpy() for o in outs)


def release(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def row_errors(got: np.ndarray, want: torch.Tensor) -> np.ndarray:
    """Each row's |got - want|_2 / |want|_2."""
    w = want.double().cpu().numpy()
    g = got.astype(np.float64)
    return (np.linalg.norm(g - w, axis=1)
            / np.maximum(np.linalg.norm(w, axis=1), 1e-30))


def w_reference(m: dict, seed: int, device, q=R.EXACT):
    """The plain W answerer on the seeded weights -> fn(u8, qst) ->
    logits [B, A] (no dropout, in blocks of rows)."""
    w = P.make(P.w_shapes(m), generate.stream(seed, 3), device)

    @torch.no_grad()
    def answer(u8: np.ndarray, qst: np.ndarray, block: int = 64):
        outs = []
        with R.exact_matmuls():
            for s in range(0, len(u8), block):
                img = R.normalize(torch.as_tensor(u8[s:s + block],
                                                  device=device))
                outs.append(R.w_forward(q, w, m, img, torch.as_tensor(
                    qst[s:s + block], device=device), None))
        return torch.cat(outs)

    return answer
