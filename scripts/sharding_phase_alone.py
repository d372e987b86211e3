"""chip_smoke's sharding phase alone, with the 4-rank gloo bodies of
``tests/_torch_sharding_ranks.py`` and the dry run's six smoke cells run
on this machine's CPU (its torch, whatever the CPU tests' one is):

    python3 scripts/sharding_phase_alone.py [ranks] [dry] [shard]

Each section prints ``SECTION <name> OK|FAILED <s>``; a failure is
printed with its traceback and the next section runs. ``shard`` needs a
GPU (it builds the kernels); the other two run on the CPU.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
          os.path.join(ROOT, "scripts")):
    sys.path.insert(0, p)


def ranks():
    import _torch_sharding_ranks as R
    for fn in (R.numerics, R.pipeline):
        print(fn.__name__, R.spawn(fn, tempfile.mkdtemp(), timeout=400),
              flush=True)


def dry():
    import dryrun_vs_reference as compare
    cells = [("yi-6b", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"),
             ("zamba2-1.2b", "long_500k"), ("hubert-xlarge", "prefill_32k"),
             ("xlstm-125m", "decode_32k"), ("hubert-xlarge", "decode_32k")]
    rows = compare.rows(compare.start(compare.PORT, cells))
    for key, row in rows.items():
        print("CELL", key, {k: row.get(k) for k in (
            "flops_per_device", "coll_bytes_per_device", "skipped")},
            flush=True)


def shard():
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(["sample_attr", "flash_attention", "rmsnorm",
                  "stream_marker"])
    with cs.phase("sharding"), cs.watchdog(600, "sharding phase"):
        print("SHARD_OK", cs.sharding_phase(torch.device("cuda")),
              flush=True)


def main(argv):
    if shutil.which("nvidia-smi"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    sections = {"ranks": ranks, "dry": dry, "shard": shard}
    for name in argv or list(sections):
        t0 = time.perf_counter()
        try:
            sections[name]()
            ok = "OK"
        except Exception:
            traceback.print_exc()
            ok = "FAILED"
        print(f"SECTION {name} {ok} {time.perf_counter() - t0:.1f} s",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
