"""to_host_ms.frame: the milliseconds of ``render_image``'s ``to_host`` span
(the page-locked buffer, the copy and the wait for the frame's kernels
behind it), the median over the frames of the window traced on the device
alone (the program's spans, ``spans.measured``)."""

from rtbench.core import spans


def read(trace):
    return spans.part_ms(spans.program_spans(trace), "render_image", "to_host")
