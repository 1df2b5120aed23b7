"""Each fault this benchmark's cells can have, planted under the timed
path of a whole run (the look for a card skipped, the run on the CPU at
tiny size), turns ``correct`` false; the sound run stays true."""

import numpy as np
import pytest

from h100bench import harness, tiny

SLOTS = 40             # the window, in engine slots


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def alter_committed_token(eng):
    """A committed token altered where the verify produces it."""
    fn, V = eng._verify, eng.llm.cfg.vocab_size

    def bad(ids, drafts, depths):
        n_acc, out, out_len = fn(ids, drafts, depths)
        out[0, n_acc[0]] = (out[0, n_acc[0]] + 1) % V
        return n_acc, out, out_len
    eng._verify = bad


def ssm_state_unchanged(eng):
    """Every SSM decode step (draft and catch-up) returns its KV pool as
    it found it."""
    for b in eng.ssms:
        fn = b.decode_paged

        def bad(cache, toks, lengths, bt, cfg=None, fn=fn):
            logits, _ = fn({k: v.clone() for k, v in cache.items()}, toks,
                           lengths, bt, cfg)
            return logits, cache
        b.decode_paged = bad


def alter_draft(eng):
    """A drafted token altered where the SSM produces it."""
    fn, V = eng._draft_pool, eng.llm.cfg.vocab_size

    def bad(j, width, depths):
        cand = fn(j, width, depths)
        cand[:, -1] = (cand[:, -1] + 1) % V
        return cand
    eng._draft_pool = bad


def run(root, patch=None, seed=21):
    r = harness.run_cell("tiny.closed", seed, 1.0, False, root=root,
                         device="cpu", slots=SLOTS, patch=patch)
    return r["correct"], {k: v["value"] for k, v in r["checks"].items()}


def test_sound_run_is_correct(root):
    ok, checks = run(root)
    assert ok, checks


@pytest.mark.parametrize("fault,number", [
    (alter_committed_token, "llm_gap"),
    (ssm_state_unchanged, "draft_gap"),
    (alter_draft, "draft_gap")], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_caught(root, fault, number):
    ok, checks = run(root, fault)
    assert not ok and checks[number] > 1e-3, checks


def test_kv_writes_dropped(root, monkeypatch):
    """Every step returns the KV pools unchanged."""
    from repro_torch.serving import paged
    monkeypatch.setattr(paged, "_write_kv", lambda *a, **k: None)
    ok, checks = run(root)
    assert not ok and checks["llm_gap"] > 1e-3, checks


def test_pick_takes_the_longest():
    rng = np.random.default_rng(0)
    got = harness.check.pick([3, 9, 1, 4, 7], 3, rng)
    assert got[0] == 1 and len(set(got)) == 3
