"""The control at a size a test run can hold: the reference in float8
e4m3 put in the program's place, read at the positions of bfloat16 runs of
the tiny cell, and judged by the harness's own comparison.  On the card
the same readings, at each cell's size, set the limits (``calibrate.py``;
PERF.md gives them)."""

import pytest

from h100bench import harness, tiny

LIMIT = 0.05          # between this size's program and control readings

SLOTS = 40             # the window, in engine slots


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"), "bfloat16",
                          LIMIT)
    out = []
    for seed in (1000, 1001, 1002, 1003):
        r = harness.run_cell("tiny.closed", seed, 1.0, False, root=root,
                             device="cpu", slots=SLOTS, control=True)
        out.append(({k: v["value"] for k, v in r["program"].items()},
                    {k: v["value"] for k, v in r["checks"].items()},
                    r["program_correct"], r["correct"]))
    return out


def test_program_in_bfloat16_passes(readings):
    for checks, _, ok, _ in readings:
        assert ok, checks


def test_control_fails_a_number(readings):
    for checks, control, _, _ in readings:
        assert max(control[k] for k in checks) > LIMIT, control
    # the readings the limit sits between: the control's smallest widest
    # gap well above the program's largest
    lower = max(max(c.values()) for c, _, _, _ in readings)
    upper = min(max(k.values()) for _, k, _, _ in readings)
    assert lower < LIMIT < upper and upper > 2 * lower


def test_control_run_is_not_correct(readings):
    """The control in the program's place comes out as not correct."""
    for _, control, _, correct in readings:
        assert not correct, control
