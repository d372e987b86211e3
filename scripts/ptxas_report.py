"""Print each CUDA kernel's registers, shared memory and spills as ptxas
reports them (``nvcc -Xptxas -v``), on a machine with the CUDA toolkit.

Run from the repository root:

    python3 scripts/ptxas_report.py [kernel ...]

with kernel names as in ``src/repro_torch/kernels/`` (default: all three).
Each source is compiled with the port's own flags (``_build.NVCC_FLAGS``)
into ``build/ptxas/`` (git-ignored), all at once; the committed build is
not touched. Exits non-zero if a compile fails.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("sample_attr", "flash_attention", "rmsnorm")


def main(names):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    out_dir = os.path.join(ROOT, "build", "ptxas")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(out_dir, f"lib{name}.so"), str(_build._source(name))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in names}
    failed = False
    for name, proc in procs.items():
        log, _ = proc.communicate()
        failed |= proc.returncode != 0
        lines = [ln.strip() for ln in log.splitlines()
                 if "Compiling entry" in ln or "Used" in ln
                 or "spill" in ln or "error" in ln]
        print(f"ptxas {name} (nvcc exit {proc.returncode}):")
        for ln in lines:
            print("  " + ln)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or KERNELS))
