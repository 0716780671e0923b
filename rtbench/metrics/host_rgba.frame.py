"""host_rgba.frame: the share of the frames of the window traced on the
device alone whose ``render_image`` span carries ``host_rgba`` 1 (the host
made a pass over the pixels to assemble the image), in %, of the frames
whose span carries the attribute (the program's spans, ``spans.measured``).
None where no span carries it."""

from rtbench.core import spans


def read(trace):
    calls = [s for s in spans.program_spans(trace) or ()
             if s.parent is None and s.name == "render_image"
             and "host_rgba" in s.attrs]
    if not calls:
        return None
    return 100.0 * sum(s.attrs["host_rgba"] == 1 for s in calls) / len(calls)
