"""The host-paced latency a MSM, in ms: the traced calls' time (the
`msmbench.call` spans) less the port's `msm.wait.*` spans inside them, over
the MSMs.  It is the time the host spends issuing work and decoding, not
blocked on the card or the CUDA runtime."""

from msmbench import hostspans


def read(tw):
    cw = hostspans.call_waits(tw)
    if cw is None:
        return None
    return (cw.call_us - cw.wait_us) / 1e3 / cw.msms
