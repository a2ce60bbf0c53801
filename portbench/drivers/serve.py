"""Open-loop online answering: single pairs due as a Poisson stream at the
mix's fixed rate, each sent by a client thread of a pool through the
port's `MicroBatcher.call("answer_logits", ...)`, which groups them into
batched `ServingModel` calls.

Each request is timed from its due time to its answer on the host, so a
stalled sender's lateness counts against the requests it delayed; how
late the sender ran is printed on an earlier line. A request that fails
or has no answer a minute past the window's close counts as missing. The
check compares a seeded sample of the answered requests with the plain
W reference, row by row.
"""

from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import flops, generate
from portbench.drivers import serving as S
from portbench.harness import percentile

SAMPLED_REQUESTS = 256
LATE_WAIT_S = 60.0


class Driver:
    unit = "request"
    e2e = "answer_p95_ms"

    def __init__(self, ctx):
        self.ctx = ctx
        self.m = ctx.config["model"]
        self.mix = ctx.mix
        self.fault = ctx.fault

    def setup(self) -> None:
        from lctvqa_torch.serve import MicroBatcher

        ctx = self.ctx
        pool = generate.answer_batches(ctx.seed, self.mix, self.m)
        self.images = np.concatenate([b["image_u8"] for b in pool])
        self.questions = np.concatenate([b["question"] for b in pool])
        self.model = S.serving_model(ctx.config, "w", ctx.seed, ctx.device,
                                     int8=self.fault == "int8")
        self.batcher = MicroBatcher(self.model, **self.mix["batcher"])
        # every bucket the batcher can dispatch, as the port's warmup does
        for n in MicroBatcher.buckets(self.batcher.max_batch):
            self.model.answer_logits(self.images[:n], self.questions[:n])
        self.clients = ThreadPoolExecutor(self.mix["clients"])
        # every client thread started now, not on the window's first
        # requests
        gate = threading.Barrier(self.mix["clients"] + 1)
        started = [self.clients.submit(gate.wait)
                   for _ in range(self.mix["clients"])]
        gate.wait()
        for f in started:
            f.result()
        self.rate = float(self.mix["rate"])

    def window(self, seconds: float, tracer) -> dict:
        due = generate.arrivals(self.ctx.seed, self.rate, seconds)
        n_rows = len(self.images)
        g = generate.rng(self.ctx.seed, 50)
        rows = g.integers(0, n_rows, len(due))
        keep = set(g.choice(len(due), min(SAMPLED_REQUESTS, len(due)),
                            replace=False).tolist())
        lat = np.full(len(due), np.nan)
        late = np.zeros(len(due))
        answers = {}
        lock = threading.Lock()
        batches_before = len(self.batcher.batch_sizes)

        def request(i, t_due):
            try:
                out = self.batcher.call("answer_logits", self.images[rows[i]],
                                        self.questions[rows[i]])
                if self.fault == "answer":
                    out = np.roll(out, 1)
                done = time.perf_counter()
                with lock:
                    lat[i] = done - t_due
                    if i in keep:
                        answers[i] = np.asarray(out)
            except Exception as exc:  # noqa: BLE001 - counted as missing
                print(f"portbench: request {i} failed: {exc}",
                      file=sys.stderr)

        futures = []
        t0 = time.perf_counter()
        for i, d in enumerate(due):
            t_due = t0 + d
            wait = t_due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[i] = time.perf_counter() - t_due
            futures.append(self.clients.submit(request, i, t_due))
            tracer.tick()
        t_end = t0 + seconds
        for f in futures:
            f.result(timeout=max(t_end + LATE_WAIT_S - time.perf_counter(),
                                 0.0))
        tracer.close()
        elapsed = time.perf_counter() - t0
        ok = np.isfinite(lat)
        print(f"portbench: sender lateness ms p50 "
              f"{percentile(late, 50) * 1e3:.4f} p99 "
              f"{percentile(late, 99) * 1e3:.4f} max "
              f"{late.max() * 1e3:.4f} over {len(due)} requests",
              file=sys.stderr)
        # a request with no answer counts as missing any limit
        lat_ms = np.where(ok, lat * 1e3, np.inf)
        if not hasattr(self, "answers"):
            # the first window's: a traced stretch after it is not judged
            self.answers, self.rows = answers, rows
        groups = self.batcher.batch_sizes[batches_before:]
        return {"seconds": elapsed, "attempted": len(due),
                "failed": int((~ok).sum()),
                "values": {"answer_p95_ms": percentile(lat_ms, 95)},
                "latency_ms": lat_ms, "groups": groups,
                "units": len(due),
                "flops": sum(flops.w_fwd_flops(self.m, 1 << (n - 1)
                                               .bit_length())
                             for n in groups)}

    def release(self) -> None:
        self.clients.shutdown(wait=True)
        self.model = self.batcher = None
        S.release(self.ctx.device)

    def check(self) -> dict:
        ref = S.w_reference(self.m, self.ctx.seed, self.ctx.device)
        idx = sorted(self.answers)
        if not idx:
            return {"logit_err": float("inf")}
        r = self.rows[idx]
        want = ref(self.images[r], self.questions[r])
        got = np.stack([self.answers[i] for i in idx])
        return {"logit_err": float(S.row_errors(got, want).max())}
