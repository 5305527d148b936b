"""library_device_ms.<unit>: device milliseconds a profiled unit spends in
kernels that are none of the program's own (``work/kernels.py``):
cuBLAS, cuSOLVER and PyTorch's kernels, the block solver's among them."""


def read(r):
    return 1e3 * r.library_seconds() / len(r.work) if r.work else None
