"""The host side of a run, as the benchmark deploys it: one thread for
the CPU-side tensor and array work.  The host paces the program, and idle
pool threads spinning beside it only add noise.  ``run.py`` and
``calibrate.py`` both call :func:`one_thread` before they import torch."""

import os

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def one_thread():
    for var in THREAD_VARS:
        os.environ[var] = "1"
    import torch
    torch.set_num_threads(1)
