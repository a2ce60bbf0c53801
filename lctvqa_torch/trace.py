"""Spans: the port's one way of naming what the host is doing.

`span(name)` wraps a layer boundary of the training step, the feed or
a serving call. It always adds the host seconds it was open, and one to
its count, to a process-wide table (`TABLE`), which the training loop's
`| TIMING |` line prints once an epoch and then clears. While
`torch.autograd`'s profiler records on the calling thread it also opens
a record function named `lctvqa.<name>`, so that the span lies on the
profiler's timeline, on the clock of the device operations launched
inside it; with no profiler recording, none is opened (the check costs
well under a microsecond).

The record function is an operator's (`_RecordFunctionFast`), not a
user annotation (`torch.profiler.record_function`): the profiler copies
a user annotation onto the device's timeline as one span of whatever
ran under it, where a reader of device operations would count it as an
operation and its whole extent as busy. A span on the host alone leaves
every reading of the device as it was.

`count(name)` adds one to a name's count with no time (the BatchNorm
routes of `ops/conv.py::batchnorm`), and not while `torch.compile` or
`torch.export` traces. The TIMING line prints such a name's count alone.

A span neither synchronizes the device nor records an event: its times
are the host's enqueue, plus whatever waiting fell inside it. No span
is opened inside a function that `export.export_programs` traces: there
it would time the trace, not a call.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict

import torch

PREFIX = "lctvqa."

_profiling = torch._C._autograd._profiler_enabled


class SpanTable:
    """Host seconds and counts of each span name since the last
    `reset`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._t0 = time.perf_counter()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def count(self, name: str) -> None:
        with self._lock:
            self.counts[name] += 1

    def summary(self) -> str:
        """One line: each span's host total, count and mean, each counted
        name's count, and the wall time since the last reset."""
        with self._lock:
            parts = [f"{name}: {tot:.2f}s/{self.counts[name]} "
                     f"({1000 * tot / max(self.counts[name], 1):.1f}ms avg)"
                     for name, tot in sorted(self.totals.items())]
            parts += [f"{name}: {n}" for name, n in sorted(
                self.counts.items()) if name not in self.totals]
        parts.append(f"wall: {time.perf_counter() - self._t0:.2f}s")
        return "host enqueue times: " + " | ".join(parts)

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self._t0 = time.perf_counter()


TABLE = SpanTable()


def count(name: str) -> None:
    """One more of `name` in `TABLE` (no time); nothing while a graph is
    traced."""
    if not torch.compiler.is_compiling():
        TABLE.count(name)


class span:
    """`with span("stage1.forward"): ...` (the module's docstring)."""

    __slots__ = ("name", "_t0", "_record")

    def __init__(self, name: str):
        self.name = name
        self._record = None

    def __enter__(self):
        if _profiling():
            self._record = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name)
            self._record.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        TABLE.add(self.name, time.perf_counter() - self._t0)
        if self._record is not None:
            self._record.__exit__(*exc)
            self._record = None
        return False
