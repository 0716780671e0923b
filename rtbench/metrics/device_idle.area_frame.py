"""device_idle.area_frame: the share of the traced window of sampled
frames in which no operation ran on the card, from the profiler's device
events (their union)."""

from rtbench.core.trace import idle_percent


def read(trace):
    return idle_percent(trace)
