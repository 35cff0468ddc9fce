"""Seconds of the fixed base's precompute (precompute_msm_base), on the host
clock up to a synchronize, in set-up after the kernels were loaded."""


def read(tw):
    return tw.setup.get("precompute_s")
