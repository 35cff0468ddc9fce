"""The metric arithmetic: the window's rate, the tail over all calls, the
work counts against a count by hand, and the trace's readers."""

from __future__ import annotations

import numpy as np
import pytest

from msmbench import reference, spec, stats, testroot, trace, workcount

REPO = testroot.REPO


def test_msm_ms_is_the_window_over_its_msms():
    assert stats.msm_ms(20.0, 1000) == pytest.approx(20.0)
    assert stats.msm_ms(20.0, 4 * 300) == pytest.approx(20000 / 1200)   # a batch counts 4
    with pytest.raises(ValueError):
        stats.msm_ms(1.0, 0)


def test_p95_counts_every_call():
    calls = [17.0] * 95 + [100.0] * 5
    # The outliers are counted, not trimmed: the 95th percentile sits among them.
    assert stats.p95(calls) > 17.0
    assert stats.p95([17.0] * 100) == 17.0
    assert stats.p95(list(range(1, 101))) == pytest.approx(95.95)


def test_spread():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0
    assert stats.spread([9.0, 10.0, 10.0, 11.0]) == pytest.approx(1.5 / 10)


def _digits_by_hand(k: int, c: int, windows: int) -> list[int]:
    out, carry = [], 0
    for j in range(windows):
        d = ((k >> (c * j)) & ((1 << c) - 1)) + carry
        carry = int(d >= 1 << (c - 1))
        out.append(d - (carry << c))
    assert carry == 0 and sum(d << (c * j) for j, d in enumerate(out)) == k
    return out


def _words(ks):
    return np.array([[(k >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for k in ks], np.uint32)


def test_nonzero_digits_by_hand():
    ks = [0, 1, (1 << 16) + 1, 0xFFFF, reference.R - 1, 1 << 250, 12345 << 100]
    want = sum(sum(d != 0 for d in _digits_by_hand(k, 16, 16)) for k in ks)
    assert workcount.nonzero_signed_digits(_words(ks), 16, 16) == want
    assert workcount.nonzero_signed_digits(_words([0xFFFF]), 16, 16) == 2   # -1, then the carry
    rng = np.random.default_rng(3)
    ks = [int(x) % reference.R for x in rng.integers(0, 2**63, 50)] + [reference.R - 7]
    for c, w in ((13, 20), (16, 16), (12, 22)):
        want = sum(sum(d != 0 for d in _digits_by_hand(k, c, w)) for k in ks)
        assert workcount.nonzero_signed_digits(_words(ks), c, w) == want


def test_accumulation_work_at_2p20_by_hand():
    # Uniform scalars: a digit of a 16-bit window is zero with odds 2^-16, so
    # 2^20 scalars * 16 windows give 2^24 mixed additions less about 256.
    digits = 16 * 2**20 - 256
    assert workcount.accum_muladds(digits) == digits * 7 * 272
    t, by = workcount.least_time_s(workcount.accum_muladds(digits),
                                   workcount.accum_input_bytes(2**20, 16, False))
    assert by == "ops" and t == pytest.approx(2**24 * 7 * 272 / 16.75e12, rel=1e-4)
    assert t * 1e3 == pytest.approx(1.907, abs=0.001)
    # Over a fixed base the 2^24 shifted points (1.07 GB) and the scalars
    # are read once: 0.33 ms, still under the operations' bound.
    fb = workcount.accum_input_bytes(2**20, 16, True)
    assert fb == 2**24 * 64 + 2**20 * 32
    assert workcount.least_time_s(workcount.accum_muladds(digits), fb)[1] == "ops"
    assert workcount.least_time_s(1.0, fb)[1] == "bytes"


def test_uniform_scalars_count_near_2p24():
    from msmbench import inputs
    vec = inputs.below_order(np.random.default_rng(5), 1 << 16)
    nz = workcount.nonzero_signed_digits(vec, 16, 16)
    assert abs(nz - 16 * 2**16) < 64


def _tw(device, host=(), start=0.0, end=1000.0, msms=2, digits=0, nbytes=0, setup=None):
    return trace.TraceWindow([trace.Event(*d) for d in device], [trace.Event(*h) for h in host],
                             start, end, msms, digits, nbytes, setup or {})


def test_busy_union_and_idle():
    tw = _tw([("a", 100, 300), ("b", 200, 400), ("c", 600, 700), ("d", 950, 1200)])
    assert trace.busy_us(tw) == pytest.approx(300 + 100 + 50)
    assert trace.idle_gaps(tw) == [(0, 100), (400, 600), (700, 950)]
    assert spec.metric_reader(REPO, "device_idle_pct")(tw) == pytest.approx(55.0)
    assert spec.metric_reader(REPO, "device_ops_per_msm")(tw) == 2.0


def test_idle_gaps_are_labelled_by_the_innermost_host_op():
    tw = _tw([("k1", 100, 200), ("k2", 500, 600)],
             [(trace.CALL_SPAN, 0, 700), ("aten::nonzero", 150, 450),
              ("cudaMemGetInfo", 300, 420), (trace.CALL_SPAN, 750, 1000)])
    b = trace.breakdown(tw)
    got = dict(b["idle_gaps"])
    # 0-100 python in the call; 200-500 around cudaMemGetInfo (its middle at
    # 350); 600-700 python in the call; 700-1000 (middle 850) in the second call.
    assert got == pytest.approx({trace.IN_CALL: 100e-6 + 100e-6 + 300e-6,
                                 "cudaMemGetInfo": 300e-6})
    assert dict(b["device_ops"]) == pytest.approx({"k1": 100e-6, "k2": 100e-6})
    # A gap takes the label of its middle: 10-100 has it at 55, between calls.
    gaps = _tw([("k", 0, 10)], [(trace.CALL_SPAN, 0, 20), (trace.CALL_SPAN, 60, 100)], 0, 100)
    assert trace.breakdown(gaps)["idle_gaps"] == [[trace.BETWEEN_CALLS, pytest.approx(90e-6)]]


def test_short_names_keep_the_kernel_and_drop_its_arguments():
    assert trace.short_name("msm::ab_scan_kernel(int const*, unsigned int const*)") == \
        "msm::ab_scan_kernel"
    name = ("void at::native::(anonymous namespace)::distribution_kernel<long, 4>"
            "(at::TensorIteratorBase&, long)")
    assert trace.short_name(name) == \
        "void at::native::(anonymous namespace)::distribution_kernel<long, 4>"
    assert trace.short_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH (Device -> Pageable)"


def test_kernel_readers_and_roofline():
    dev = [("void msm::scan_kernel<2, 0, 2>(unsigned int const*)", 0, 4000),
           ("msm::ab_scan_kernel(int const*)", 4000, 4500),
           ("msm::bpr_stage1_kernel(x)", 4500, 5000),
           ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<x>", 5000, 6000)]
    digits = 2**24
    tw = _tw(dev, msms=1, digits=digits, nbytes=workcount.accum_input_bytes(2**20, 16, False),
             end=7000)
    assert spec.metric_reader(REPO, "port_kernels_ms")(tw) == pytest.approx(5.0)
    assert spec.metric_reader(REPO, "torch_glue_ms")(tw) == pytest.approx(1.0)
    least = 2**24 * 7 * 272 / 16.75e12
    assert spec.metric_reader(REPO, "accum_roofline_pct")(tw) == pytest.approx(
        100 * least / 4.5e-3)
    empty = _tw([("void at::native::copy", 0, 10)])
    for name in ("port_kernels_ms", "accum_roofline_pct", "precompute_s"):
        assert spec.metric_reader(REPO, name)(empty) is None
    assert spec.metric_reader(REPO, "precompute_s")(_tw([], setup={"precompute_s": 0.5})) == 0.5
