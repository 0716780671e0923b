"""k5_roofline.step: K5's bound over its summed device time in the traced
steps (``rtbench/roofline/k5.py``)."""

from rtbench.roofline import k5


def read(trace):
    return k5.share(trace)
