"""Median latency of every request in the window, from its due time
to its answer on the host (a missing answer counts as infinitely late)."""


from portbench.harness import percentile


def read(run):
    lat = run.window.get("latency_ms")
    return percentile(lat, 50) if lat is not None and len(lat) else None
