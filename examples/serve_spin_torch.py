"""Serve a batched workload through the full SPIN engine (PyTorch port).

    PYTHONPATH=src python examples/serve_spin_torch.py \
        [--dataset mix] [--requests 8] [--selector lbss] [--device cpu] \
        [--zoo]

The launcher ``repro_torch.launch.serve`` with its flags: LBSS selection of
heterogeneous SSMs (with fast switching), request-decomposed packed
verification and micro-batch pipelining; prints the run's stats as JSON.
Runs on the card unless ``--device cpu`` is given.  ``--zoo`` serves the
trained zoo of ``examples/train_distill_ssm_torch.py`` (restored from its
cache, trained there first if there is none) instead of random weights.
"""

import os
import sys

from repro_torch.launch.serve import main as serve_main


def main(argv):
    argv = list(argv)
    zoo = None
    if "--zoo" in argv:
        argv.remove("--zoo")
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from train_distill_ssm_torch import build_zoo
        device = (argv[argv.index("--device") + 1] if "--device" in argv
                  else "cuda")
        zoo = build_zoo(device=device)
    return serve_main(argv, zoo=zoo)


if __name__ == "__main__":
    main(sys.argv[1:])
