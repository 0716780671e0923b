"""entry_host_ms.step: the host's milliseconds in ``train_step`` outside its
child spans (the step's loop, the scene's partition and its combination),
the median over the steps of the window traced on the device alone (the
program's spans, ``spans.measured``)."""

from rtbench.core import spans


def read(trace):
    return spans.self_ms(spans.program_spans(trace), "train_step")
