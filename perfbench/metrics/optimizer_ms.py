"""optimizer_ms.<unit>: host milliseconds of the workflow optimizer's passes
in one more unit (a fit or an apply call) run under a ``PipelineTrace``
after the profiled ones (its ``meta["optimizer_runs"][*]["wall_s"]``)."""


def read(r):
    return None if r.optimizer_s is None else 1e3 * r.optimizer_s
