"""Device events (kernels, copies, memsets) a MSM in the traced calls: the
operations the host dispatches, one by one, for each MSM."""


def read(tw):
    if not tw.device or not tw.msms:
        return None
    return len(tw.device) / tw.msms
