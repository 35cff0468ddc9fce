"""The time a MSM, in ms, that the host spends blocked on the card or the
CUDA runtime: the port's `msm.wait.*` spans inside the traced calls."""

from msmbench import hostspans


def read(tw):
    cw = hostspans.call_waits(tw)
    if cw is None:
        return None
    return cw.wait_us / 1e3 / cw.msms
