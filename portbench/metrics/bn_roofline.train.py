"""The BatchNorm kernels' share of their roofline in training: the
bounds of every forward launch in the profiled stretch and of the
backward of each that took a gradient, at their shapes, over the summed
device time of `bn_fwd_kernel` and `bn_bwd_kernel` there."""


from portbench import roofline


def read(run):
    p = run.profile
    if p is None or not run.shapes.bn:
        return None
    bound = sum(roofline.bn_fwd(n, x, y)
                + (roofline.bn_bwd(n, x, y) if grad else 0.0)
                for n, x, y, grad in run.shapes.bn)
    spent = p.kernel_s("bn_fwd_kernel", "bn_bwd_kernel")
    return 100.0 * bound / spent if spent > 0 else None
