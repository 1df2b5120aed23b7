"""device_mem_gib: ``torch.cuda.max_memory_allocated()`` over the run,
read before the check, in GiB."""


def read(rec):
    b = rec["memory_peak_bytes"]
    return b / 2**30 if b else None
