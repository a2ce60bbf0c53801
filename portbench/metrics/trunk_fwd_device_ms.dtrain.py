"""Device milliseconds a step of the operations enqueued inside the
harness's marked span `trunk` around each call of the derived trunk's
forward (stage 1's, under autograd, and stage 2's generation), in the
profiled stretch (host-to-device copies left out)."""


def read(run):
    p = run.profile
    segs = p.segments("trunk") if p is not None else None
    return 1e3 * sum(segs) / p.units if segs and p.units else None
