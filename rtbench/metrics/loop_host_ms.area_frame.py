"""loop_host_ms.area_frame: the host's milliseconds in the device loop's
stages (the key, the entry on a miss, staging, the capture on a miss,
replay enqueue), summed a request, from the program's own record of each
traced sampled frame (``kernels.last_frame()``), averaged over the traced
requests."""

from rtbench.core.trace import mean


def read(trace):
    return mean(trace.get("host_ms"))
