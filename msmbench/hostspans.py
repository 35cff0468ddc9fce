"""The port's host spans in a traced window, for the host-dispatch metrics.

The port wraps each place where a call blocks on the card or the CUDA
runtime in a span named `msm.wait.<what>`, and its host-only work in one named
`msm.host.<what>` (the port's utils/tracing.py).  A span encloses no device
work, so it appears among the host's events alone.  A program without such
spans gives no reading: a window in which no host event's name starts with
`msm.` holds nothing to read.
"""

from __future__ import annotations

import dataclasses

from msmbench import trace

PORT_PREFIX = "msm."
WAIT_PREFIX = "msm.wait."


@dataclasses.dataclass
class CallWaits:
    call_us: float      # the msmbench.call spans' time, summed
    wait_us: float      # the msm.wait.* spans' time inside them, summed
    waits: int          # the msm.wait.* spans inside them
    msms: int


def call_waits(tw: trace.TraceWindow) -> CallWaits | None:
    """The traced calls' time and the waits inside them; None where the
    window has no call, no MSM or no span of the port."""
    calls = [e for e in tw.host if e.name == trace.CALL_SPAN]
    if not calls or not tw.msms or not any(e.name.startswith(PORT_PREFIX) for e in tw.host):
        return None
    waits = [e for e in tw.host if e.name.startswith(WAIT_PREFIX)
             and any(c.start_us <= e.start_us and e.end_us <= c.end_us for c in calls)]
    return CallWaits(sum(c.us for c in calls), sum(w.us for w in waits), len(waits), tw.msms)
