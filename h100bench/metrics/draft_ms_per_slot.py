"""draft_ms_per_slot: time in ``SpinEngine._draft_pool`` (every SSM's
draft steps; the harness's span, the card synchronized at both ends) per
slot of the traced run's span slots, which follow its window, in ms."""


def read(rec):
    n = rec["span_slots"]
    if not n or not rec["spans"]:
        return None
    return rec["spans"]["draft"][0] / n * 1e3
