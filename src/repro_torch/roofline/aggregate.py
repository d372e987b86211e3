"""Aggregate dry-run JSON rows into the EXPERIMENTS.md roofline tables.

    PYTHONPATH=src python -m repro_torch.roofline.aggregate results/dryrun/
"""

from __future__ import annotations

import json
import os
import re
import sys


def load_rows(d: str) -> list[dict]:
    rows = []
    for name in sorted(os.listdir(d)):
        if not name.endswith(".json") or name.startswith("VARIANT"):
            continue
        with open(os.path.join(d, name)) as f:
            data = json.load(f)
        mesh = "multi" if "__multi" in name else "single"
        for row in data if isinstance(data, list) else [data]:
            row["mesh_kind"] = mesh
            rows.append(row)
    return rows


def fmt_bytes(n) -> str:
    if n is None:
        return "-"
    return f"{n/2**30:.2f}"


def table(rows: list[dict], mesh_kind: str) -> str:
    hdr = ("| arch | shape | t_comp ms | t_mem ms | t_coll ms | dominant | "
           "roofline frac | model/HLO flops | GB/dev |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        if r.get("mesh_kind") != mesh_kind:
            continue
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skip: {r['skipped']} | — | — | — |")
            continue
        if "error" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"ERROR {r['error'][:40]} | — | — | — |")
            continue
        mem_gb = None
        m = re.search(r"temp_size_in_bytes=(\d+)", r.get("mem_analysis", ""))
        a = re.search(r"argument_size_in_bytes=(\d+)",
                      r.get("mem_analysis", ""))
        if m and a:
            mem_gb = int(m.group(1)) + int(a.group(1))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']*1e3:.2f} | "
            f"{r['t_memory_s']*1e3:.2f} | {r['t_collective_s']*1e3:.2f} | "
            f"{r['dominant']} | {r['roofline_fraction']:.3f} | "
            f"{r['model_flops_ratio']:.2f} | {fmt_bytes(mem_gb)} |")
    return "\n".join(lines)


def main():
    d = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun"
    rows = load_rows(d)
    done = [r for r in rows if "t_compute_s" in r]
    skipped = [r for r in rows if "skipped" in r]
    failed = [r for r in rows if "error" in r]
    print(f"cells: {len(done)} compiled, {len(skipped)} skipped, "
          f"{len(failed)} failed\n")
    print("## Single-pod mesh 16x16 (256 chips)\n")
    print(table(rows, "single"))
    print("\n## Multi-pod mesh 2x16x16 (512 chips)\n")
    print(table(rows, "multi"))
    # Hillclimb candidates.
    singles = [r for r in done if r["mesh_kind"] == "single"]
    if singles:
        worst = min(singles, key=lambda r: r["roofline_fraction"])
        coll = max(singles, key=lambda r: r["t_collective_s"]
                   / max(r["t_compute_s"] + r["t_memory_s"], 1e-12))
        print(f"\nworst roofline fraction: {worst['arch']}×{worst['shape']}"
              f" ({worst['roofline_fraction']:.3f})")
        print(f"most collective-bound: {coll['arch']}×{coll['shape']}")


if __name__ == "__main__":
    main()
