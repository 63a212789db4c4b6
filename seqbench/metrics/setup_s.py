"""Set-up: process start to the first timed call (imports, the CUDA
context, the kernels' build or load, the inputs, one warm pass)."""


def read(r):
    return r.setup_s
