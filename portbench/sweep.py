"""The knee of an open-loop serving cell: the highest offered rate that the
system sustains without a growing backlog, found once by a sweep on the
card (the benchmark's own runs offer the fixed rate of the cell's mix and
never search):

    python3 -m portbench.sweep --workload <cell> --seed <n> \
        --rates 1000 2000 ... [--seconds 10]

One process sets the cell up once, then runs a window at each rate in
turn and prints one JSON line a rate: the rate offered and completed,
the latency's median and 95th percentile over every request, the same
over the first and the last quarter of the window's requests (a backlog
that grows shows as a last quarter far slower than the first), the mean
group the batcher dispatched and the sender's lateness.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import run as B
from portbench.harness import Tracer, percentile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args(argv)
    B._cache_dirs()
    spec = B.lookup(B.load_json(B.ROOT / "BENCHMARK.json"), a.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    drv = B.driver_class(spec["mix"])(B.Context(spec, a.seed, device))
    drv.setup()
    for rate in a.rates:
        drv.rate = rate
        w = drv.window(a.seconds, Tracer(False))
        lat = w["latency_ms"]
        q = max(len(lat) // 4, 1)
        done = int(np.isfinite(lat).sum())
        print(json.dumps({
            "rate": rate, "completed_per_s": done / w["seconds"],
            "requests": len(lat), "failed": w["failed"],
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "first_quarter_p95_ms": percentile(lat[:q], 95),
            "last_quarter_p95_ms": percentile(lat[-q:], 95),
            "group_mean": float(np.mean(w["groups"])) if w["groups"] else 0,
        }), flush=True)
    drv.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
