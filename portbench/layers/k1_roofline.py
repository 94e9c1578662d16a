"""k1_roofline: the QA kernel K1's share of its roofline in the traced
stretch: the sum over its launches of the least time the card could take
(``roofline.bound_ms``, bytes over HBM bandwidth: the bound is memory),
over the device time of the kernels named ``projection_kernel`` in the
trace, in percent; nothing where K1 did not run."""

NAME = "projection_kernel"


def read(run):
    p = run.profile
    if p is None or p.k1_bounds_ms <= 0:
        return None
    device_s = sum(s for name, s in p.kernels.items() if NAME in name)
    if device_s <= 0:
        return None
    return 100.0 * p.k1_bounds_ms * 1e-3 / device_s
