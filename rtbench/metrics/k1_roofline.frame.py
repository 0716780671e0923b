"""k1_roofline.frame: K1's bound over its summed device time in the traced
frames (``rtbench/roofline/k1.py``)."""

from rtbench.roofline import k1


def read(trace):
    return k1.share(trace)
