"""mfu.query: the traced calls' counted operations (K11's walk) over what
the card's float32 peak does in the traced window."""

from rtbench.core.trace import mfu_percent
from rtbench.roofline import k11


def read(trace):
    return mfu_percent(trace, (k11,))
