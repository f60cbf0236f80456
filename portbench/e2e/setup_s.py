"""Set-up: process start to the first timed request (imports, the CUDA
context, the kernels loaded or built, the network generated, one warm-up
request at the cell's shapes)."""


def read(run):
    return run.setup_s
