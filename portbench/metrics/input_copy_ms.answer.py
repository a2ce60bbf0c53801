"""Device milliseconds a call of host-to-device copies (the batch's
images and questions), in the profiled stretch."""


def read(run):
    p = run.profile
    if p is None or not p.units:
        return None
    return 1e3 * p.h2d_s() / p.units
