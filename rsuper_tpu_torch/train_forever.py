#!/usr/bin/env python
"""Crash-restart loop around the training CLI: the counterpart of the JAX
package's ``tools/train_forever.sh`` (the reference's ``train_on_merlin.sh``
while-loop).

    python -m rsuper_tpu_torch.train_forever [train args...]

Runs ``python -m rsuper_tpu_torch.train --resume ARGS`` again and again
until an attempt exits 0, sleeping ``COOLDOWN`` seconds (environment
variable, default 20) between attempts. Each attempt resumes from the run's
``latest`` checkpoint; the first starts fresh where there is none.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Sequence

TRAIN = (sys.executable, "-m", "rsuper_tpu_torch.train")


def run(args: Sequence[str], command: Sequence[str] = TRAIN) -> int:
    """Run ``command --resume args`` until it exits 0, ``COOLDOWN`` seconds
    apart; returns 0."""
    cooldown = float(os.environ.get("COOLDOWN", "20"))
    while True:
        code = subprocess.call([*command, "--resume", *args])
        if code == 0:
            print("training finished cleanly", flush=True)
            return 0
        print(f"training exited with code {code}; restarting in "
              f"{cooldown:g}s", file=sys.stderr, flush=True)
        time.sleep(cooldown)


def main(argv=None) -> int:
    return run(sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    sys.exit(main())
