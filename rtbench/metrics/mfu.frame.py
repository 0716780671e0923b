"""mfu.frame: the traced frames' counted operations (K1's and K4's) over
what the card's float32 peak does in the traced window."""

from rtbench.core.trace import mfu_percent
from rtbench.roofline import k1, k4


def read(trace):
    return mfu_percent(trace, (k1, k4))
