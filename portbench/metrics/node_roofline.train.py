"""The mixed-op node kernels' share of their roofline in training:
the bounds of every forward and backward launch in the profiled
stretch, at each launch's shapes (`portbench/roofline.py`), over the
summed device time of the node kernels there."""


from portbench import roofline

FWD = ("node_stage_a", "node_stage_b", "node_final", "node_stat_finish")
BWD = ("node_bwd",)


def read(run):
    p = run.profile
    if p is None or not run.shapes.node:
        return None
    bound = sum(roofline.node_fwd(n, h, w, cs, e, d)
                + (roofline.node_bwd(n, h, w, cs, e, d) if grad else 0.0)
                for n, h, w, cs, e, d, grad in run.shapes.node)
    spent = p.kernel_s(*FWD, *BWD)
    return 100.0 * bound / spent if spent > 0 else None
