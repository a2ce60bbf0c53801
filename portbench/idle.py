"""Where a cell's device idle time falls among the program's own spans
(`lctvqa_torch/trace.py`: the host operators named `lctvqa.<name>` that
the port opens while a profiler records), read on the card:

    python3 -m portbench.idle --workload <cell> --seed <n> [--seconds 10]

One process sets the cell up, runs an untraced window of `--seconds`
(so that the profiled stretch is as warm as a traced run's), then
profiles one stretch of the cell's `trace_start` and `trace_units`
exactly as a `--trace 1` run does, and prints one JSON line: the
stretch's harness readings (`kernels_per_unit`, `busy_s`, `window_s`),
the device events that carry a program span's name (none, where the
spans stay on the host), and for each program span name its count,
host milliseconds and device-idle milliseconds a unit (idle instants at
which the driver's thread was inside it, at any depth), the idle a unit
outside every program span and its share of the idle, and the longest
idle gaps named by the innermost span, the harness's or the program's,
open on the driver's thread as each began. The driver's thread is the
thread of the harness's `pb.window`. The benchmark's runs never call
this.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from portbench.harness import Profile, Tracer

PREFIX = "lctvqa."
Interval = Tuple[float, float]


def merge(intervals) -> List[Interval]:
    """The union of `intervals`, as sorted disjoint (start, end) pairs."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(xs: Sequence[Interval], ys: Sequence[Interval]) -> float:
    """Length of the intersection of two sorted disjoint lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


class Spans:
    """The program's spans of one profiled stretch, beside the harness's
    reading of the same events (`Profile`), in the profiler's
    microseconds."""

    def __init__(self, events, profile: Profile):
        from torch.autograd import DeviceType

        self.p = profile
        host = [e for e in events if e.device_type == DeviceType.CPU]
        window = [e for e in host if e.name == "pb.window"]
        self.thread = getattr(window[0], "thread", None) if window else None
        # (name, start, end) on the driver's thread, cut to the stretch
        self.program = [
            (e.name, max(e.time_range.start, profile.start),
             min(e.time_range.end, profile.end))
            for e in host if e.name.startswith(PREFIX)
            and getattr(e, "thread", None) == self.thread
            and e.time_range.end > profile.start
            and e.time_range.start < profile.end]
        self.on_device = sorted({e.name for e in events
                                 if e.device_type != DeviceType.CPU
                                 and e.name.startswith(PREFIX)})

    def idle(self) -> List[Interval]:
        """The stretch's instants with nothing on the device: the
        complement of the harness's busy union inside its window."""
        union = self.p._union()
        edges = [self.p.start] + [x for ab in union for x in ab] + [
            self.p.end]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def inside(self, *names: str) -> List[Interval]:
        """Instants at which the driver's thread is inside a span of one
        of `names` (every program span without names)."""
        return merge((a, b) for n, a, b in self.program
                     if not names or n in names)

    def idle_inside(self, *names: str) -> float:
        """Device-idle seconds at instants inside `names`' spans."""
        return overlap(self.idle(), self.inside(*names)) * 1e-6

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest idle gaps, each named by the innermost span (the
        shortest of those open as it began), the harness's or the
        program's; "pb.loop" where none is open."""
        spans = ([s for s in self.p.spans if s[0] != "pb.window"]
                 + self.program)
        out = []
        for a, b in sorted(self.idle(), key=lambda g: g[0] - g[1])[:n]:
            inner = [s for s in spans if s[1] <= a < s[2]]
            name = (min(inner, key=lambda s: s[2] - s[1])[0] if inner
                    else "pb.loop")
            out.append([name, (b - a) * 1e-6])
        return out

    def table(self) -> Dict[str, dict]:
        """Each program span name's count, host ms and idle ms a unit."""
        host: Dict[str, float] = defaultdict(float)
        count: Dict[str, int] = defaultdict(int)
        for name, a, b in self.program:
            host[name] += (b - a) * 1e-6
            count[name] += 1
        u = max(self.p.units, 1)
        return {name: {"count": count[name] / u,
                       "host_ms": 1e3 * host[name] / u,
                       "idle_ms": 1e3 * self.idle_inside(name) / u}
                for name in sorted(host)}

    def reading(self) -> dict:
        u = max(self.p.units, 1)
        idle = self.p.window_s - self.p.busy_s
        outside = idle - self.idle_inside()
        return {"units": self.p.units,
                "kernels_per_unit": self.p.kernels / u,
                "busy_s": self.p.busy_s, "window_s": self.p.window_s,
                "device_events_named_by_spans": self.on_device,
                "spans": self.table(),
                "idle_ms": 1e3 * idle / u,
                "idle_outside_ms": 1e3 * outside / u,
                "idle_outside_share": outside / idle if idle > 0 else None,
                "idle_gaps": self.idle_gaps()}


class KeepingTracer(Tracer):
    """The harness's Tracer, keeping the raw events of its stretch."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.events: list = []

    def _finish(self) -> None:
        prof = self._prof
        super()._finish()
        self.events = list(prof.events())


def profile_cell(spec: dict, seed: int, seconds: float, device) -> dict:
    """Set-up, an untraced window, one profiled stretch -> `reading()`."""
    import torch

    from portbench import run as B

    drv = B.driver_class(spec["mix"])(B.Context(spec, seed, device))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    drv.setup()
    drv.window(seconds, Tracer(False, device=device))
    mix = spec["mix"]
    stretch = KeepingTracer(True, start=mix.get("trace_start", 2),
                            units=mix.get("trace_units", 3), device=device)
    stretch.warm()
    drv.window(mix.get("trace_seconds", 0.0), stretch)
    drv.release()
    if stretch.profile is None:
        raise RuntimeError("no stretch was profiled")
    return Spans(stretch.events, stretch.profile).reading()


def main(argv=None) -> int:
    import torch

    from portbench import run as B

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args(argv)
    B._cache_dirs()
    spec = B.lookup(B.load_json(B.ROOT / "BENCHMARK.json"), a.workload)
    device = torch.device("cuda", 0)
    out = profile_cell(spec, a.seed, a.seconds, device)
    out.update(workload=a.workload, seed=a.seed,
               device=torch.cuda.get_device_name(device))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
