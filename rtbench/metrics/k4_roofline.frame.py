"""k4_roofline.frame: K4's bound over its summed device time in the traced
frames (``rtbench/roofline/k4.py``)."""

from rtbench.roofline import k4


def read(trace):
    return k4.share(trace)
