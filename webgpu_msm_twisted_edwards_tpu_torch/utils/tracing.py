"""The port's host spans: named `torch.profiler` ranges around each place
where a call blocks on the device or the CUDA runtime (`msm.wait.*`) and
around its host-only work (`msm.host.*`), so that a profiler's trace can say how
long the host spends issuing work and how long it is blocked.

A span encloses no launch and no copy: the profiler copies a
`record_function` range that encloses device work onto the device's
timeline, where a reader of device events would count it as device work.
The spans are always on.  Each is a `_RecordFunctionFast`, about 0.4 us on
the H100's host outside a profiler, where a `record_function` takes about
13 us (two dispatched operators): five of those a call made `compute_msm`
at 2^16 about 4% slower.
"""

from __future__ import annotations

import torch

#: The scalar guard's wait for its compare, before `nonzero` reads it.
WAIT_GUARD = "msm.wait.guard"
#: The query of the device's total memory (`torch.cuda.mem_get_info`).
WAIT_MEMINFO = "msm.wait.meminfo"
#: The wait for a MSM's total, before its copy to the host.
WAIT_RESULT = "msm.wait.result"
#: The host's decode of a total into affine Python integers.
HOST_DECODE = "msm.host.decode"

SPANS = (WAIT_GUARD, WAIT_MEMINFO, WAIT_RESULT, HOST_DECODE)


def span(name: str) -> torch._C._profiler._RecordFunctionFast:
    """A context manager that records the range `name` in a profiler's
    trace."""
    return torch._C._profiler._RecordFunctionFast(name)


def wait(name: str, device: torch.device) -> None:
    """Block until the work queued on `device`'s current stream is done,
    inside the span `name` (on the CPU, where nothing is queued, the span
    alone)."""
    with span(name):
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
