"""The port's engine-free speculation API (``core/spec_decode.py``:
``verify_greedy``, ``verify_sampling``, ``spec_iteration``) against the
JAX reference on the CPU, over dense caches, with float32 weights bridged
from the JAX tree and the same numpy prompts.

Greedy speculation is token-exact: every iteration's emitted tokens,
accept counts, lengths and the caches' segment ids (the two rollback
windows of ``spec_iteration``) equal the reference's, and the emitted
stream equals plain greedy decoding.  Sampling draws from ``jax.random``
in the reference, which torch cannot replay, so ``verify_sampling`` is
held to the LLM's distribution by a chi-square test (p > 1e-3)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from scipy import stats

from repro.configs import registry as jregistry
from repro.core import spec_decode as jsd
from repro.models import transformer as JT
from repro_torch.core import spec_decode as sd
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_numpy
from torch_fleet import one_thread  # noqa: F401

VOCAB = 256
CPU = torch.device("cpu")


def bridge(jb):
    cfg = ModelConfig(**dataclasses.asdict(jb.cfg))
    return sd.Bundle(cfg, from_jax_numpy(jax.tree.map(np.asarray, jb.params),
                                         cfg, CPU))


def jax_bundle(arch, seed, **kw):
    cfg = jregistry.reduced_for(arch, **kw)
    return jsd.Bundle(cfg, JT.init_params(cfg, jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def zoo():
    jllm = jax_bundle("llama-7b", 0, d_model=96, n_heads=4, n_kv_heads=4,
                      vocab_size=VOCAB)
    jssm = jax_bundle("llama-68m", 1, d_model=32, n_heads=4, n_kv_heads=4,
                      vocab_size=VOCAB, n_layers=1)
    return jllm, jssm, bridge(jllm), bridge(jssm)


def prompts(B, P, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, VOCAB, (B, P)).astype(np.int32)
    lens = np.array([P - 3 * b for b in range(B)], np.int32)
    return toks, lens


def greedy_reference(llm, prompt, n_new):
    """Plain greedy decoding of one prompt through the port's dense
    cache."""
    P = len(prompt)
    toks = torch.as_tensor(np.asarray(prompt, np.int32))[None]
    lengths = torch.tensor([P], dtype=torch.int32)
    lg, cache = llm.prefill(toks, lengths, P + n_new + 8)
    tok = torch.argmax(lg[:, P - 1, :VOCAB], -1, keepdim=True).to(torch.int32)
    out = [int(tok)]
    for _ in range(n_new - 1):
        lg, cache = llm.decode(cache, tok, lengths)
        lengths = lengths + 1
        tok = torch.argmax(lg[:, -1, :VOCAB], -1, keepdim=True).to(
            torch.int32)
        out.append(int(tok))
    return out


def _seg(cache):
    return np.asarray(cache["seg"])


def _jseg(jcache):
    return np.stack([np.asarray(jcache["scan"]["u0_attn"]["seg"][u])
                     for u in range(jcache["scan"]["u0_attn"]["seg"]
                                    .shape[0])])


@pytest.mark.parametrize("draft", ["ssm", "llm"])
def test_spec_iteration_token_exact(zoo, draft):
    """Six iterations at gamma 4 over three rows of unequal prompts; the
    LLM as its own draft model accepts every candidate (bonus path)."""
    jllm, jssm, llm, ssm = zoo
    if draft == "llm":
        jssm, ssm = jllm, llm
    toks, lens = prompts(3, 12, 0)
    gamma, max_len = 4, 64
    jl, jlc = jllm.prefill(jnp.asarray(toks), jnp.asarray(lens), max_len)
    _, jsc = jssm.prefill(jnp.asarray(toks), jnp.asarray(lens), max_len)
    tl, lc = llm.prefill(torch.from_numpy(toks), torch.from_numpy(lens),
                         max_len)
    _, sc = ssm.prefill(torch.from_numpy(toks), torch.from_numpy(lens),
                        max_len)
    rows = np.arange(3)
    jlast = jnp.argmax(jl[rows, lens - 1, :VOCAB], -1)[:, None].astype(
        jnp.int32)
    last = torch.argmax(tl[rows, lens - 1, :VOCAB], -1)[:, None].to(
        torch.int32)
    assert np.array_equal(np.asarray(jlast), last.numpy())
    jlen, tlen = jnp.asarray(lens), torch.from_numpy(lens)
    emitted = [[int(t)] for t in last[:, 0]]
    accepted = 0
    for it in range(6):
        (jout, jout_len, jn, jlc, jsc, jlen, jlast) = jsd.spec_iteration(
            jllm, jssm, jlc, jsc, jlast, jlen, gamma,
            jax.random.PRNGKey(it))
        out, out_len, n, lc, sc, tlen, last = sd.spec_iteration(
            llm, ssm, lc, sc, last, tlen, gamma)
        for got, want in ((out, jout), (out_len, jout_len), (n, jn),
                          (tlen, jlen), (last, jlast)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # the rollback windows: every slot's segment id
        np.testing.assert_array_equal(_seg(lc), _jseg(jlc))
        np.testing.assert_array_equal(_seg(sc), _jseg(jsc))
        accepted += int(n.sum())
        for b in range(3):
            emitted[b] += [int(x) for x in out[b, :int(out_len[b])]]
    if draft == "llm":
        assert accepted == 6 * 3 * gamma
    for b in range(3):
        want = greedy_reference(llm, toks[b, :lens[b]], len(emitted[b]))
        assert emitted[b] == want, b


def test_verify_greedy_matches(zoo):
    """Candidates that agree with the LLM for a random prefix length per
    row, then diverge: accept counts, emitted rows and lengths."""
    jllm, _, llm, _ = zoo
    toks, lens = prompts(4, 14, 1)
    gamma, max_len = 5, 48
    rng = np.random.default_rng(2)
    cand = np.zeros((4, gamma), np.int32)
    agree = [0, 2, 5, 3]
    jl, jc = jllm.prefill(jnp.asarray(toks), jnp.asarray(lens), max_len)
    last = np.array(jnp.argmax(jl[np.arange(4), lens - 1, :VOCAB], -1),
                    np.int32)[:, None]
    for b in range(4):
        chain = greedy_reference(llm, list(toks[b, :lens[b]]), gamma + 1)
        cand[b] = chain[1:]
        if agree[b] < gamma:
            cand[b, agree[b]] = (chain[1 + agree[b]] + 1 + rng.integers(
                VOCAB - 1)) % VOCAB
    jn, jout, jlen, _ = jsd.verify_greedy(jllm, jc, jnp.asarray(last),
                                          jnp.asarray(cand),
                                          jnp.asarray(lens))
    _, c = llm.prefill(torch.from_numpy(toks), torch.from_numpy(lens),
                       max_len)
    n, out, out_len, _ = sd.verify_greedy(llm, c, torch.from_numpy(last),
                                          torch.from_numpy(cand),
                                          torch.from_numpy(lens))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(n.numpy(), agree)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))


@pytest.mark.parametrize("draft", ["ssm", "llm"])
def test_verify_sampling_follows_the_llm(draft):
    """One sampling iteration over 6000 copies of one prompt (vocab 16):
    the first emitted token (an accepted draft or the residual resample)
    follows the LLM's next-token distribution; with the LLM as its own
    draft every candidate is accepted and the bonus comes from p[gamma]."""
    V, B, P, gamma = 16, 6000, 6, 2
    kw = dict(d_model=32, n_heads=4, n_kv_heads=4, vocab_size=V)
    llm = bridge(jax_bundle("llama-7b", 3, **kw))
    ssm = llm if draft == "llm" else bridge(jax_bundle("llama-68m", 4, **kw,
                                                       n_layers=1))
    prompt = np.random.default_rng(5).integers(1, V, (1, P)).astype(np.int32)
    toks = torch.from_numpy(np.repeat(prompt, B, 0))
    lens = torch.full((B,), P, dtype=torch.int32)
    lg, lc = llm.prefill(toks, lens, P + gamma + 4)
    _, sc = ssm.prefill(toks, lens, P + gamma + 4)
    gen = torch.Generator().manual_seed(7)
    # the first input token is itself a draw from p(. | prompt)
    p0 = torch.softmax(lg[0, P - 1, :V].float(), -1)
    last = sd.sample(p0.expand(B, V), gen)[:, None].to(torch.int32)
    out, out_len, n, *_ = sd.spec_iteration(
        llm, ssm, lc, sc, last, lens, gamma, gen, temperature=1.0)
    if draft == "llm":
        assert bool((n == gamma).all())
    # p(. | prompt, last) per distinct `last`: pool the first emitted token
    # of every row against its own conditional
    ctx = torch.cat([torch.from_numpy(prompt), torch.zeros(1, 1,
                                                           dtype=torch.int32)],
                    1).repeat(V, 1)
    ctx[:, P] = torch.arange(V)
    lg1, _ = llm.prefill(ctx, torch.full((V,), P + 1, dtype=torch.int32),
                         P + 1)
    p1 = torch.softmax(lg1[:, P, :V].float(), -1)       # (V, V)
    expected = p1[last[:, 0].long()].sum(0).double().numpy()
    observed = np.bincount(out[:, 0].numpy(), minlength=V)
    keep = expected >= 5
    exp = np.append(expected[keep], expected[~keep].sum())
    obs = np.append(observed[keep], observed[~keep].sum())
    if exp[-1] == 0:
        exp, obs = exp[:-1], obs[:-1]
    assert stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue > 1e-3
