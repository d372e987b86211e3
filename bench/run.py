"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Needs a CUDA card (exits 2 without one, or
with fewer than the cell asks for); exits 3 if a module of the JAX side
was loaded, and 4 if a metric the cell lists found nothing to read. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; then ``checks``, each number the
check compared beside its limit, which are also the last lines of
standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}     # top-level module names
ROOT = BENCH.parent


def _finite(obj):
    """``obj`` with every infinite or NaN float replaced by the largest
    float, so that the line is strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return 1.7976931348623157e308
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # One process with few threads: no pool of CPU threads beside the
    # launching thread. Caches of the program's tool chains stay inside
    # the checkout.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(
        ROOT / "build" / "bench" / "torch_extensions")
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import torch
    import harness
    cell = harness.load_cell(ROOT, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    age = harness.process_age()
    t_start = T0 if age is None else time.perf_counter() - age
    result = harness.run(cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), dev=torch.device("cuda", 0),
                         t_start=t_start)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"modules of the JAX side loaded: {loaded}", file=sys.stderr)
        return 3
    lacking = harness.missing(cell, result, bool(args.trace))
    if lacking:
        print(f"{args.workload}: nothing read for {lacking}, which the cell "
              f"lists", file=sys.stderr)
        return 4
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
