"""mfu.area_frame: the traced sampled frames' counted operations (K1's,
K4's, K7's and K8's) over what the card's float32 peak does in the traced
window."""

from rtbench.core.trace import mfu_percent
from rtbench.roofline import k1, k4, k7, k8


def read(trace):
    return mfu_percent(trace, (k1, k4, k7, k8))
