"""setup_s: process start to the first timed call: imports, the CUDA
context, the kernel and codec builds or cache loads, input generation and
warm-up."""


def read(run):
    return run.setup_s
