"""mfu.<unit>: the profiled units' counted operations (the configuration's
algorithm, ``work/``) over their span times the card's TF32 peak, in
percent."""
from perfbench.work import mfu


def read(r):
    return mfu(r.flops(), r.trace.window_s) if r.work else None
