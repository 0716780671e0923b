"""k11_roofline.query: the bound of K11 and its refit over their summed
device time in the traced calls (``rtbench/roofline/k11.py``)."""

from rtbench.roofline import k11


def read(trace):
    return k11.share(trace)
