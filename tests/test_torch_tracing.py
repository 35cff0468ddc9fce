"""The port's host spans (utils/tracing.py) in a profiler's trace of one
`compute_msm` on the CPU at 4096 points: the bucket pipeline at c = 13,
W = 20.  Each wait and the decode appear as often as the call's path
reaches them, none encloses an operator (so none can enclose a launch),
and the answer is the benchmark's reference's."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from msmbench import inputs, reference
from webgpu_msm_twisted_edwards_tpu_torch import compute_msm
from webgpu_msm_twisted_edwards_tpu_torch.utils import tracing

N = 4096


@pytest.fixture(scope="module")
def traced_msm():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inp = inputs.make(2**33 + 17, N, 1)
        coords = torch.from_numpy(inp.points.view(np.uint32).reshape(N, 2, 8).view(np.int32))
        scalars = torch.from_numpy(inp.vectors[0].view(np.int32))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = compute_msm(coords, scalars, device="cpu")
    finally:
        torch.set_num_threads(threads)
    # The profiler's raw events (name, thread, ns): the plain versions run
    # about 1.2 M operators, which prof.events() takes minutes to nest.
    events = [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    return inp, got, events


def test_spans_are_counted_and_enclose_no_operator(traced_msm):
    inp, got, events = traced_msm
    spans = [e for e in events if e[0] in tracing.SPANS]
    counts = {name: sum(e[0] == name for e in spans) for name in tracing.SPANS}
    assert counts == {tracing.WAIT_GUARD: 1, tracing.WAIT_MEMINFO: 2,
                      tracing.WAIT_RESULT: 1, tracing.HOST_DECODE: 1}
    ops = [e for e in events if e[0].startswith("aten::")]
    assert ops
    for name, thread, lo, hi in spans:
        inside = [e[0] for e in ops if e[1] == thread and lo <= e[2] and e[3] <= hi]
        assert not inside, f"{name} encloses {inside[:5]}"
    assert (got["x"], got["y"]) == reference.expected(inp.vectors[0], inp.alpha, inp.beta)
