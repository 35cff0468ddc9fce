"""The bucket accumulation's share of its roofline, in %: the least time
the card could take for the accumulation's work, counted from the inputs
(workcount.py), over the device time of the kernels that add points into
buckets (today the scan and its carry scan, by the patterns below)."""

from msmbench import workcount

PATTERNS = (r"msm::scan_kernel\b", r"msm::ab_scan_kernel\b")


def read(tw):
    us, count = tw.device_us(PATTERNS)
    if not count or not tw.nonzero_digits:
        return None
    least_s, _ = workcount.least_time_s(workcount.accum_muladds(tw.nonzero_digits),
                                        tw.input_bytes)
    return 100.0 * least_s / (us / 1e6)
