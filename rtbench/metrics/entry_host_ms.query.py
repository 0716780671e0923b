"""entry_host_ms.query: the host's milliseconds of an ``overlap_scene`` call
(its span: checks, refit and K11 enqueued), the median over the calls of the
window traced on the device alone (the program's spans,
``spans.measured``)."""

from rtbench.core import spans


def read(trace):
    return spans.root_ms(spans.program_spans(trace), "overlap_scene")
