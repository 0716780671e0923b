"""k7_roofline.area_frame: K7's bound over its summed device time in the
traced sampled frames (``rtbench/roofline/k7.py``)."""

from rtbench.roofline import k7


def read(trace):
    return k7.share(trace)
