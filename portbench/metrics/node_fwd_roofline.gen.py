"""The node forward kernel's share of its roofline in `generate`: the
bounds of its launches in the profiled stretch at their shapes over
their summed device time."""


from portbench import roofline

FWD = ("node_stage_a", "node_stage_b", "node_final", "node_stat_finish")


def read(run):
    p = run.profile
    if p is None or not run.shapes.node:
        return None
    bound = sum(roofline.node_fwd(n, h, w, cs, e, d)
                for n, h, w, cs, e, d, _ in run.shapes.node)
    spent = p.kernel_s(*FWD)
    return 100.0 * bound / spent if spent > 0 else None
