"""Readings that the check's limits are set from.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--out <file>]

For each seed of ``--seeds``: the cell's inputs as a run with that seed
makes them, one profile through the program's public entry, and the
numbers of :func:`reference.compare` against the float64 reference. For
each seed of ``--control-seeds``: the control, the same reference with
its sensor readings rounded to float32 and summed in float32, put in the
program's place and compared with the float64 reference in the same way. One JSON line per
reading on standard output (and appended to ``--out``). Needs a CUDA
card unless ``--device cpu`` is given; not run by the benchmark's runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def readings(cell, seed: int, dev, control: bool) -> dict:
    import torch
    import generator
    import harness
    import reference
    cfg = cell.config
    arrays = generator.workers(
        generator.cell_timeline(cell.traffic, cfg, seed), cfg)
    s = generator.derived_seed(seed, 2, 0)
    kw = dict(period=cfg["period_s"], jitter=cfg["jitter_s"], seed=s,
              chunk=cfg["chunk_size"], sensor=cfg["sensor"], device=dev)
    t0 = time.perf_counter()
    if control:
        low = reference.profile(arrays, fold_dtype=torch.float32, **kw)
        cols = reference.estimates(low, cfg["alpha"])
        got = (low.keys, cols, low.n, low.t_exec)
    else:
        prog = harness.Program(cell, arrays, dev)
        a = harness._answer(s, prog.profile(s))
        del prog
        got = (a["keys"], a["cols"], a["n"], a["t_exec"])
    t1 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference.profile(arrays, **kw)
    t2 = time.perf_counter()
    out = reference.compare(*got, ref, cfg["alpha"])
    out.update(workload=cell.name, seed=seed, control=control,
               samples=ref.n, rows=len(ref.keys), side_s=t1 - t0,
               reference_s=t2 - t1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import torch
    import harness
    cell = harness.load_cell(ROOT, args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    todo = [(int(s), False) for s in args.seeds.split(",") if s]
    todo += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in todo:
        line = json.dumps(readings(cell, seed, dev, control))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
