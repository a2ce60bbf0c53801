"""Host milliseconds a step spent in `next()` on the port's Prefetcher
(the harness's span around it), over the whole window."""


def read(run):
    waits = run.tracer.host.get("prefetch_next", [])
    return 1e3 * sum(waits) / len(waits) if waits else None
