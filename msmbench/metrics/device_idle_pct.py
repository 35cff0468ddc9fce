"""The share of the traced calls' wall time in which no device event ran:
1 - busy / wall, busy the union of the device's intervals, in %."""

from msmbench import trace


def read(tw):
    if not tw.device or tw.wall_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us(tw) / tw.wall_us)
