"""device_ms_per_token: the device's busy time over the whole window (the
union of its activity, profiled for the device alone in stretches that
cover the window) over the output tokens committed in the window, in ms:
the accelerator time a served token costs.  The host's speed, which
swings the host-paced rate from process to process, does not enter it."""


def read(rec):
    busy = rec.get("window_busy_s")
    if not busy or not rec["window_tokens"]:
        return None
    return 1e3 * busy / rec["window_tokens"]
