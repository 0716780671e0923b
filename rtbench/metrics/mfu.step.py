"""mfu.step: the traced steps' counted operations (K1's, K4's and K5's)
over what the card's float32 peak does in the traced window."""

from rtbench.core.trace import mfu_percent
from rtbench.roofline import k1, k4, k5


def read(trace):
    return mfu_percent(trace, (k1, k4, k5))
