"""fused_paged_decode_roofline: as ``fused_paged_verify_roofline``, for
``ops.fused_paged_decode`` (the SSMs' draft and catch-up steps) with
``work.decode_work``."""

from h100bench import kernel_roofline

CAPTURE = ("repro_torch.kernels.ops", "fused_paged_decode")


def read(rec):
    return kernel_roofline.share(rec, CAPTURE[1], "decode")
