"""mfu: model FLOPs of the real tokens (no bucket padding, no idle pool
rows) that every LLM and SSM forward processed in the window (verify,
draft, catch-up, admission prefill and SSM placement tokens, counted by
``work.py`` from the config and the shapes noted in the window, summed
after it), over the window's seconds x the H100's 989 TFLOP/s (bf16
dense), in %.  A traced run's window is profiled by nothing."""

from h100bench import work


def read(rec):
    if not rec["flops"]:
        return None
    return 100.0 * rec["flops"] / (rec["window_s"] * work.PEAK_BF16)
