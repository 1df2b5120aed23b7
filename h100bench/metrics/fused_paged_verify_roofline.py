"""fused_paged_verify_roofline: the least time of the profiled slots'
``ops.fused_paged_verify`` calls (``work.verify_work`` and ``work.bound``
from each call's shapes), over the device time inside the harness's
``record_function`` range around that entry point, in %.  The range, not
the kernel's symbol, so that a kernel that replaces #1 is still read."""

from h100bench import kernel_roofline

CAPTURE = ("repro_torch.kernels.ops", "fused_paged_verify")


def read(rec):
    return kernel_roofline.share(rec, CAPTURE[1], "verify")
