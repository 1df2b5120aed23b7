"""prefill_ms_per_request: time in ``SpinEngine._begin_admit`` (the LLM's
admission prefill and first token) and ``SpinEngine._place_on_ssm`` (the
draft model's prefill on placement or switch), synchronized spans, per
request admitted in the traced run's span slots, in ms."""


def read(rec):
    spans = rec["spans"]
    admitted = spans and spans["admit_prefill"][1]
    if not admitted:
        return None
    return ((spans["admit_prefill"][0] + spans["ssm_place"][0])
            / admitted * 1e3)
