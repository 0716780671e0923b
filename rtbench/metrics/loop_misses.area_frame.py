"""loop_misses.area_frame: the share of the sampled frames of the window
traced on the device alone whose device loop (the ``frame_device`` span)
built its graph again (``hit`` 0), in % (the program's spans,
``spans.measured``): every frame, where the seed keys the loop's graph
(each frame has a new seed); none, where one graph serves every seed."""

from rtbench.core import spans


def read(trace):
    return spans.miss_percent(spans.program_spans(trace), "frame_device")
