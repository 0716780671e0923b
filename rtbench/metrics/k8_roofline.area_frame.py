"""k8_roofline.area_frame: K8's bound over its summed device time in the
traced sampled frames (``rtbench/roofline/k8.py``)."""

from rtbench.roofline import k8


def read(trace):
    return k8.share(trace)
