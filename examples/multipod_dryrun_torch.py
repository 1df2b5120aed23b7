"""Run one (arch x shape) cell of the port's dry-run on the production
meshes, with no card:

    PYTHONPATH=src python examples/multipod_dryrun_torch.py \
        --arch qwen2-0.5b --shape decode_32k --both-meshes --roofline

Thin entry point over repro_torch.launch.dryrun, which makes its own fake
512-rank process group (so run it in its own process).
"""

import sys

from repro_torch.launch.dryrun import main

if __name__ == "__main__":
    sys.exit(main())
