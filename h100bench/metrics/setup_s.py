"""setup_s: process start to the window's start: imports and the CUDA
context, the weights, the kernels' build or load, the engine and the
traffic's warm-up slots."""


def read(rec):
    return rec["setup_s"]
