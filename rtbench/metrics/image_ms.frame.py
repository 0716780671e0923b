"""image_ms.frame: the milliseconds of ``render_image``'s ``image`` span
(the image made from the frame's host rows), the median over the frames of
the window traced on the device alone (the program's spans,
``spans.measured``)."""

from rtbench.core import spans


def read(trace):
    return spans.part_ms(spans.program_spans(trace), "render_image", "image")
