"""What every cell's run shares: the harness's spans around its calls
into the program, the profiled stretch of a traced run and its reading,
and the result line.

Spans: `Tracer.span(name)` times a call on the host clock in every run;
while a stretch is profiled it also opens a `torch.profiler`
`record_function` of that name and, with `mark=True`, enqueues a
one-thread `spin_kernel` (`torch.cuda._sleep(0)`) before and after the
call, so that the device's timeline can be cut at the span's borders:
on the call's stream every operation between the two markers was
enqueued inside the span.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

MARKER = "spin_kernel"
H2D = "Memcpy HtoD"


class Profile:
    """The device side of one profiled stretch, in microseconds of the
    profiler's clock."""

    def __init__(self, events, marker_log: List[Tuple[str, str]],
                 units: int):
        from torch.autograd import DeviceType

        self.units = units
        dev, cpu = [], []
        for e in events:
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                dev.append((e.name, tr.start, tr.end))
            elif e.device_type == DeviceType.CPU:
                cpu.append((e.name, tr.start, tr.end))
        # the profiler puts each record_function on the device's timeline
        # too (as a span of what ran under it): those are not operations
        dev = sorted((r for r in dev if not r[0].startswith("pb.")),
                     key=lambda r: r[1])
        self.markers = [r for r in dev if MARKER in r[0]]
        self.device = [r for r in dev if MARKER not in r[0]]
        self.spans = [r for r in cpu if r[0].startswith("pb.")]
        win = [r for r in self.spans if r[0] == "pb.window"]
        if win:
            self.start, self.end = win[0][1], win[0][2]
        elif self.device:
            self.start, self.end = self.device[0][1], self.device[-1][2]
        else:
            self.start = self.end = 0.0
        self.marker_log = marker_log

    @property
    def kernels(self) -> int:
        """Kernel launches seen (copies and memsets left out)."""
        return sum(1 for name, _, _ in self.device
                   if not name.startswith(("Memcpy", "Memset")))

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def _union(self):
        out = []
        for _, a, b in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union()) * 1e-6

    def kernel_s(self, *needles: str) -> float:
        """Summed device time of the operations whose name holds one of
        `needles`."""
        return sum(b - a for n, a, b in self.device
                   if any(s in n for s in needles)) * 1e-6

    def h2d_s(self) -> float:
        return self.kernel_s(H2D)

    def segments(self, name: str) -> Optional[List[float]]:
        """Device seconds of each marked span `name`: the operations that
        start between its two markers (host-to-device copies, which a
        side stream may run meanwhile, left out). None where the markers
        on the device do not pair with those the host enqueued."""
        if len(self.markers) != len(self.marker_log):
            return None
        out, begin = [], None
        for (span, edge), (_, a, b) in zip(self.marker_log, self.markers):
            if span != name:
                continue
            if edge == "begin":
                begin = b
            elif begin is not None:
                out.append(sum(
                    e - s for n, s, e in self.device
                    if begin <= s < a and H2D not in n)
                    * 1e-6)
                begin = None
        return out

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, a, b in self.device:
            by[name[:120]] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest stretches with nothing on the device, each named by
        the innermost harness span open on the host as it began."""
        union = self._union()
        edges = ([self.start] + [x for ab in union for x in ab]
                 + [self.end])
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            inner = [s for s in self.spans if s[1] <= a < s[2]
                     and s[0] != "pb.window"]
            name = (min(inner, key=lambda s: s[2] - s[1])[0] if inner
                    else "pb.loop")
            out.append([name, (b - a) * 1e-6])
        return out


class Tracer:
    """Host spans of every run; in a traced run, one profiled stretch of
    `units` units of work, starting after `start` units."""

    def __init__(self, trace: bool, start: int = 0, units: int = 0,
                 device=None):
        self.trace = bool(trace)
        self.host: Dict[str, List[float]] = defaultdict(list)
        self.ticks = 0
        self._start, self._units = start, units
        self._device = device
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._prof = None
        self._window = None
        self._log: List[Tuple[str, str]] = []
        self.profiles: List[Profile] = []
        self.misses = 0

    @property
    def profiling(self) -> bool:
        return self._prof is not None

    @property
    def pending(self) -> bool:
        """A traced stretch is still to be profiled: a driver's loop runs
        on past its seconds until it is done."""
        return self.trace and not self.profiles

    @contextlib.contextmanager
    def span(self, name: str, mark: bool = False):
        t0 = time.perf_counter()
        if not self.profiling:
            try:
                yield
            finally:
                self.host[name].append(time.perf_counter() - t0)
            return
        with torch.profiler.record_function(f"pb.{name}"):
            if mark:
                self._mark(name, "begin")
            try:
                yield
            finally:
                if mark:
                    self._mark(name, "end")
                self.host[name].append(time.perf_counter() - t0)

    def _mark(self, name: str, edge: str) -> None:
        if self._cuda:
            torch.cuda._sleep(0)
            self._log.append((name, edge))

    def tick(self) -> None:
        """One unit of work done: starts or ends the profiled stretch."""
        self.ticks += 1
        if not self.trace or self.profiles:
            return
        if self._prof is None and self.ticks >= self._start:
            self._begin()
        elif (self._prof is not None
              and self.ticks >= self._begun_at + self._units):
            self._finish()

    def _begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self._log = []
        self._prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self._cuda else []))
        self._prof.__enter__()
        self._window = torch.profiler.record_function("pb.window")
        self._window.__enter__()
        self._begun_at = self.ticks

    def warm(self) -> None:
        """Start the profiler once on a trivial operation: its first start
        in a process takes seconds (CUPTI's set-up), and a stretch profiled
        during it loses its operations."""
        if not (self.trace and self._cuda):
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=self._device).add_(1)
            self._sync()

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize(self._device)

    def _finish(self) -> None:
        self._sync()
        self._window.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        events = prof.events()
        p = Profile(events, self._log, self.ticks - self._begun_at)
        if not p.kernels:
            import sys
            names = sorted({e.name for e in events})[:12]
            print(f"portbench: the missed profile holds {len(events)} events,"
                  f" {len(p.spans)} harness spans, {len(p.markers)} markers;"
                  f" names {names}", file=sys.stderr)
            # the profiler on the card's machine sometimes sees no kernel:
            # say so and profile the next stretch
            self.misses += 1
            import sys
            print(f"portbench: profile {self.misses} saw no kernel "
                  f"({len(p.device)} other device events); profiling "
                  "again", file=sys.stderr)
            if self.misses >= 2:
                raise RuntimeError("two profiles saw no kernel")
            self._start = self.ticks + 1
            return
        self.profiles.append(p)

    def close(self) -> None:
        """End a stretch the window's end cut short."""
        if self._prof is not None:
            self._finish()

    @property
    def profile(self) -> Optional[Profile]:
        return self.profiles[0] if self.profiles else None


def percentile(xs, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation (numpy's
    default) of every value."""
    import numpy as np
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))
