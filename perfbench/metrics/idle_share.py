"""idle_share.<unit>: the share of the profiled units' span (fits, streamed
fits or apply calls) in which no operation ran on the device (kernels,
copies and sets), in percent."""


def read(r):
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
