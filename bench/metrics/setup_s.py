"""setup_s: process start to the first timed request (imports, the CUDA
context, the kernels' build or load, the graph, one warm compile)."""


def read(window):
    return window.setup_s
