"""featurize_roofline.<unit>: the featurize kernel's (``fused_featurize_kernel``)
share of its roofline in the profiled units: the least time the card
could take for the images the algorithm featurizes (each once;
``work/featurize.py``) over the kernel's device time, in percent. A
streamed fit featurizes every chunk twice, once for the scaler's pass
and once for the solver's, so there it reads half the kernel's own
share."""
from perfbench.work import roofline_share


def read(r):
    seconds = r.seconds_of("fused_featurize_kernel")
    ops, nbytes = r.total("featurize")
    return roofline_share(ops, nbytes, seconds) if seconds > 0 and ops else None
