"""k1_ident.frame: the mean, over the frames of the window traced on the
device alone, of the ``frame_device`` span's ``k1_ident``, the share of the
scene's instances whose 12 frame words are the identity's bits, which K1
enters on the world ray with no change of frame, in % (the program's
spans, ``spans.measured``). None where no span carries it."""

from rtbench.core import spans


def read(trace):
    calls = [s for s in spans.program_spans(trace) or ()
             if s.name == "frame_device" and "k1_ident" in s.attrs]
    if not calls:
        return None
    return 100.0 * sum(s.attrs["k1_ident"] for s in calls) / len(calls)
