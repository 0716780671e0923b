"""loop_host_ms.frame: the host's milliseconds in the device loop's stages
(set-up, staging, capture, replay enqueue), summed a request, from the
program's own record of each traced request (``kernels.last_frame()``),
averaged over the traced requests."""

from rtbench.core.trace import mean


def read(trace):
    return mean(trace.get("host_ms"))
