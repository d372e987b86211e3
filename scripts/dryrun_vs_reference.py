"""The port's dry-run rows beside the reference's, on the CPU.

    PYTHONPATH=src python scripts/dryrun_vs_reference.py [arch:shape ...]

Each cell runs with its reduced config on a (2, 2, 2) ("pod", "data",
"model") mesh: the port's (``repro_torch.launch.dryrun.lower_cell``)
over a fake process group of 8 ranks, the reference's
(``repro.launch.dryrun.lower_cell``) over 8 XLA host devices, each in a
subprocess of its own (run side by side). Prints, per cell, the
per-device FLOPs, HBM bytes, collective bytes and bytes per device of
both and the port's over the reference's. Default cell: yi-6b ×
train_4k (the dense cell ``tests/test_torch_dryrun.py`` holds within
10% in FLOPs).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESH = ((2, 2, 2), ("pod", "data", "model"))

PORT = textwrap.dedent("""
    import json, sys, warnings, logging
    warnings.filterwarnings("ignore"); logging.disable(logging.WARNING)
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import fake_world, lower_cell
    from repro_torch.launch.mesh import make_mesh
    fake_world(8)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="meta")
    rows = {}
    for arch, shape in json.loads(sys.argv[1]):
        row, _ = lower_cell(arch, shape, multi_pod=True, mesh=mesh,
                            cfg_override=get_config(arch).reduced())
        rows[f"{arch} {shape}"] = row
    print("ROWS " + json.dumps(rows, default=str))
""")

REF = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys, warnings
    warnings.filterwarnings("ignore")
    from repro.configs.registry import get_config
    from repro.launch.dryrun import lower_cell
    from repro.launch.mesh import make_mesh_compat
    mesh = make_mesh_compat((2, 2, 2), ("pod", "data", "model"))
    rows = {}
    for arch, shape in json.loads(sys.argv[1]):
        row, _ = lower_cell(arch, shape, multi_pod=True, mesh=mesh,
                            cfg_override=get_config(arch).reduced())
        rows[f"{arch} {shape}"] = row
    print("ROWS " + json.dumps(rows, default=str))
""")

KEYS = ("flops_per_device", "hbm_bytes_per_device", "coll_bytes_per_device",
        "bytes_per_device")


def start(script: str, cells) -> subprocess.Popen:
    """``script`` over ``cells`` [(arch, shape)] in a subprocess."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", script, json.dumps(cells)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def rows(proc: subprocess.Popen, timeout: float = 600) -> dict:
    """{"arch shape": row} printed by a :func:`start`ed subprocess."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
    if proc.returncode != 0:
        raise RuntimeError(err[-3000:])
    line = [l for l in out.splitlines() if l.startswith("ROWS ")][0]
    return json.loads(line[len("ROWS "):])


def main(argv=None):
    cells = [tuple(c.split(":")) for c in (argv or ["yi-6b:train_4k"])]
    port, ref = start(PORT, cells), start(REF, cells)
    got, want = rows(port), rows(ref)
    for arch, shape in cells:
        p, r = got[f"{arch} {shape}"], want[f"{arch} {shape}"]
        print(f"{arch} x {shape} (reduced, 2x2x2):")
        if "skipped" in p or "skipped" in r:
            print(f"  skipped: port {p.get('skipped')!r}, reference "
                  f"{r.get('skipped')!r}")
            continue
        for k in KEYS:
            print(f"  {k:22s} port {p[k]:.4e}  reference {r[k]:.4e}  "
                  f"port/reference {p[k] / r[k]:.4f}")
        print(f"  collective bytes by kind: port {p['collectives']}, "
              f"reference {r['collectives']}")


if __name__ == "__main__":
    main(sys.argv[1:])
