"""loop_misses.step: the share of the steps of the window traced on the
device alone whose device loop (the ``loss_grads_device`` span) built its
graph again (``hit`` 0), in % (the program's spans, ``spans.measured``)."""

from rtbench.core import spans


def read(trace):
    return spans.miss_percent(spans.program_spans(trace), "loss_grads_device")
