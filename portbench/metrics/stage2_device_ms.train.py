"""Device milliseconds a step of the operations enqueued inside the
harness's span around `Experiment.steps["stage2"]`, in the profiled
stretch (host-to-device copies, the Prefetcher's, left out)."""


def read(run):
    p = run.profile
    segs = p.segments("stage2") if p is not None else None
    return 1e3 * sum(segs) / len(segs) if segs else None
