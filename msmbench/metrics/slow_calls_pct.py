"""The share of the window's calls (the traced ones left out) that took over
1.5 times the median call, on the host clock, in %: the host's stalls, which
make the tail of a cell's latency."""

import statistics


def read(tw):
    calls = tw.window_calls_ms
    if len(calls) < 2:
        return None
    med = statistics.median(calls)
    return 100.0 * sum(c > 1.5 * med for c in calls) / len(calls)
