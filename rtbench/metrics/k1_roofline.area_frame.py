"""k1_roofline.area_frame: K1's bound over its summed device time in the
traced sampled frames (``rtbench/roofline/k1.py``), its work counted by
the plain walk on rays of those frames with their own light points, so
on the area lights' shadow rays."""

from rtbench.roofline import k1


def read(trace):
    return k1.share(trace)
