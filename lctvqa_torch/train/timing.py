"""Per-stage wall time (port of lctvqa/train/timing.py).

A stage's time is taken on the host clock around work that the device
may not have finished: PyTorch returns before the kernels end. So the
totals are exact only over a whole epoch, and `summary` synchronizes the
device once before it closes the books; a single stage's share is the
time the host spent enqueueing it plus whatever waiting fell inside it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class StageTimer:
    """Accumulates wall seconds per stage name."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        parts = []
        for name in sorted(self.totals):
            n, tot = self.counts[name], self.totals[name]
            parts.append(f"{name}: {tot:.2f}s/{n} "
                         f"({1000 * tot / max(n, 1):.1f}ms avg)")
        parts.append(f"wall: {time.perf_counter() - self._t0:.2f}s")
        return " | ".join(parts)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self._t0 = time.perf_counter()
