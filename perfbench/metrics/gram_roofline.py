"""gram_roofline.<unit>: the Gram kernel's (``gram_cross_kernel``) share of
its roofline in the profiled units: the least time the card could take
for each launch's Gram triangle and cross product (``work/solve.py``'s
``gram_work`` summed over the stream's chunks) over the kernel's device
time, in percent."""
from perfbench.work import roofline_share


def read(r):
    seconds = r.seconds_of("gram_cross_kernel")
    ops, nbytes = r.total("gram")
    return roofline_share(ops, nbytes, seconds) if seconds > 0 and ops else None
