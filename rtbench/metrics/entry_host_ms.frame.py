"""entry_host_ms.frame: the host's milliseconds in ``render_image`` outside
its child spans (the frame's loop, the copy to the host, the image), the
median over the frames of the window traced on the device alone (the
program's spans, ``spans.measured``)."""

from rtbench.core import spans


def read(trace):
    return spans.self_ms(spans.program_spans(trace), "render_image")
