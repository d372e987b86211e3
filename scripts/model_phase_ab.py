"""chip_smoke's model phase (qwen3-1.7b prefill + 32 decode steps) of two
trees in turns, each run in its own process, on one card:

    python3 scripts/model_phase_ab.py <parent tree> <change tree> [rounds]

Unpack each tree with ``git archive`` into a git-ignored directory (e.g.
``build/parent``, ``build/final``). Runs parent, change, change, parent
``rounds`` times (default 1) and prints each run's model line (prefill
ms, decode ms a step). Each tree builds its own kernels on first use.
"""

import os
import subprocess
import sys

CODE = """
import sys, torch
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build(["sample_attr", "flash_attention", "rmsnorm", "stream_marker"])
cs.model_phase(torch.device("cuda"))
"""


def main(argv):
    trees = {"parent": os.path.abspath(argv[0]),
             "change": os.path.abspath(argv[1])}
    rounds = int(argv[2]) if len(argv) > 2 else 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for name in ("parent", "change", "change", "parent") * rounds:
        r = subprocess.run([sys.executable, "-c", CODE], cwd=trees[name],
                           capture_output=True, text=True, timeout=600)
        lines = [l for l in r.stdout.splitlines() if "prefill B=" in l]
        print(name, r.returncode,
              lines[-1] if lines else r.stderr[-1500:], flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
