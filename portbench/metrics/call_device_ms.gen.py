"""Device milliseconds a `ServingModel.generate` call: every kernel and
copy of the profiled stretch, where the device runs nothing but the
calls, over the calls in it."""


def read(run):
    p = run.profile
    if p is None or not p.units:
        return None
    return 1e3 * sum(b - a for _, a, b in p.device) * 1e-6 / p.units
