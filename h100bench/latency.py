"""The window's request latencies as the clients saw them (wall ms)."""


def ttft(rec):
    """Hand-off to first output token, over every request handed to the
    engine in the window; one still without a token counts at the
    window's end."""
    t0, t1 = rec["window"]
    return [((r.first if r.first is not None else t1) - r.handoff) * 1e3
            for r in rec["requests"] if t0 <= r.handoff < t1]


def tpot(rec):
    """(last token's time - first token's) / (tokens - 1), over every
    request finished in the window."""
    t0, t1 = rec["window"]
    return [(r.last - r.first) / (r.n - 1) * 1e3 for r in rec["requests"]
            if r.finished is not None and t0 <= r.finished <= t1 and r.n > 1]
