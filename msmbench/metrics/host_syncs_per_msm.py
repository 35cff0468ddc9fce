"""The host's waits on the card or the CUDA runtime a MSM: the count of the
port's `msm.wait.*` spans inside the traced calls."""

from msmbench import hostspans


def read(tw):
    cw = hostspans.call_waits(tw)
    if cw is None:
        return None
    return cw.waits / cw.msms
