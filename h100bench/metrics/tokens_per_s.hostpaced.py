"""tokens_per_s.hostpaced: output tokens committed in the window over the
window's seconds (host clock, the card synchronized at both ends), read
in a traced run, whose window nothing profiles.  A per-layer metric: the
host paces these cells, and its speed, drawn anew for each process,
spreads the rate wider than any bound the contract allows."""


def read(rec):
    return rec["window_tokens"] / rec["window_s"] if rec["window_tokens"] else None
