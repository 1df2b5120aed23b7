"""slot_ms: the window's seconds over its engine slots, in ms."""


def read(rec):
    n = len(rec["slots"])
    return rec["window_s"] / n * 1e3 if n else None
