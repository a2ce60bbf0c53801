"""Device kernels a training step in the profiled stretch (the
profiler's kernel events; copies, memsets and the harness's markers
left out): an exact count."""


def read(run):
    p = run.profile
    if p is None or not p.units:
        return None
    return p.kernels / p.units
