"""Time variants of a kernel (``sample_attr`` or ``rmsnorm``) beside the
committed one, in one process on one GPU.

Run from the repository root on a machine with the GPU, with each
variant's source anywhere in the checkout, e.g. under the git-ignored
``build/``:

    python3 scripts/kernel_variant.py KERNEL [--time-only] VARIANT.cu ...

A variant keeps the committed C interface (the wrapper's ``_ARGTYPES``
and, for ``sample_attr``, ``sample_attr_tile`` and
``sample_attr_max_channels``). It is built with the port's flags
(``_build.NVCC_FLAGS``) into ``build/variants/``, next to the committed
kernel built as usual, and swapped in through the wrapper's ``_kernel``.

``sample_attr``: on ``chip_smoke.py``'s uniform-id cases and on the full
cell's chunk (k = 700), each version's fold is held to
``sample_attr_fold_ref`` (counts equal, sums rtol 1e-10) and compared
with the emulation of the committed summation order
(``sample_attr_fold_emulated``; printed, not checked, since a variant
may sum in another order). ``rmsnorm``: at ``chip_smoke.py``'s shapes in
bfloat16 and float32, each version is held to ``rmsnorm_ref`` at the
reference's limits. Then each variant is timed beside the committed
kernel in turns, committed, variant, variant, committed: device ms per
call from torch.profiler (the kernel's own launches). ``--time-only``
skips the checks, for variants that leave out a stage to show what it
costs. Prints the card's name and power limit first. Exits non-zero if a
build or a check fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_variant(kernel: str, source: str) -> str:
    """Path of the variant's library, built with the port's flags."""
    from repro_torch.kernels import _build
    data = open(source, "rb").read()
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode() + data)
    out = os.path.join(ROOT, "build", "variants",
                       f"lib{kernel}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                               source], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"variant build failed:\n{proc.stdout}{proc.stderr}")
    return out


def _split(kern):
    return ", ".join(f"{k.split('<')[0].split()[-1]} {v:.4f}"
                     for k, v in sorted(kern.items()))


def turns(cs, use, libs, name, fn, match):
    """Device ms of ``fn`` for the committed kernel and each variant, in
    turns committed, variant, variant, committed."""
    for var in list(libs)[1:]:
        times = []
        for lib in ("committed", var, var, "committed"):
            use(lib)
            ms, kern = cs.device_ms(fn, match=match)
            times.append(f"{lib} {cs._fmt(ms)} ({_split(kern)})")
        cs.log(f"kernel_variant {name}: device ms per call "
               + ", ".join(times))


def sample_attr(cs, sources, check_results):
    import torch
    from repro_torch.kernels.sample_attr import ops
    from repro_torch.kernels.sample_attr.ref import (
        sample_attr_fold_emulated, sample_attr_fold_ref)
    libs = {"committed": ops._kernel()}
    for src in sources:
        libs[os.path.basename(src)] = ops._Lib(ctypes.CDLL(
            build_variant("sample_attr", src)))
    dev = torch.device("cuda")

    def use(name):
        ops._kernel = lambda: libs[name]   # the wrapper's seam
        ops._SCRATCH.clear()

    cases = [(f"sample_attr uniform R={R} C={C}", R, C,
              cs.sample_attr_inputs(65536, R, C, R * 10 + C, dev))
             for R in (16, 4096) for C in (1, 4)]
    chunk = cs.FullChunk(cs.full_timeline(), dev)
    cases.append(("sample_attr full chunk k=700", chunk.R, chunk.C,
                  (chunk.ids, chunk.pows, chunk.valid)))
    for name, R, C, (ids, pows, valid) in cases:
        if check_results:
            want = cs.fresh_carry(R, C, dev)
            sample_attr_fold_ref(*want, ids, pows, valid)
            emu = cs.fresh_carry(R, C, dev)
            sample_attr_fold_emulated(*emu, ids, pows, valid)
            same = {}
            for lib in libs:
                use(lib)
                got = cs.fresh_carry(R, C, dev)
                ops.sample_attr_fold(*got, ids, pows, valid)
                torch.cuda.synchronize()
                cs.check(torch.equal(got[0], want[0]),
                         f"{lib} {name}: counts")
                for g, w in zip(got[1:], want[1:]):
                    cs.check(torch.allclose(g, w, rtol=cs.KERNEL_RTOL,
                                            atol=0.0),
                             f"{lib} {name}: sums rtol {cs.KERNEL_RTOL}")
                same[lib] = all(torch.equal(a, b) for a, b in zip(got, emu))
            cs.log(f"kernel_variant {name}: bitwise equal to the emulation: "
                   f"{same}")
        carry = cs.fresh_carry(R, C, dev)
        turns(cs, use, libs, name,
              lambda: ops.sample_attr_fold(*carry, ids, pows, valid),
              cs.SAMPLE_ATTR_KERNELS)
    use("committed")


def rmsnorm(cs, sources, check_results):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    libs = {"committed": ops._kernel()}
    for src in sources:
        lib = ctypes.CDLL(build_variant("rmsnorm", src))
        lib.rmsnorm_fwd.argtypes = list(ops._ARGTYPES)
        lib.rmsnorm_fwd.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        libs[os.path.basename(src)] = lib

    def use(name):
        ops._kernel = lambda: libs[name]   # the wrapper's seam

    g = torch.Generator(device="cuda").manual_seed(13)
    for n, d in cs.RMSNORM_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(n, d, generator=g, device="cuda").to(dt)
            s = 0.4 + 0.2 * torch.rand(d, generator=g, device="cuda")
            name = f"rmsnorm [{n}, {d}] {str(dt)[6:]}"
            if check_results:
                want = rmsnorm_ref(x, s, eps=1e-5)
                for lib in libs:
                    use(lib)
                    got = ops.rmsnorm(x, s, eps=1e-5)
                    torch.cuda.synchronize()
                    if dt == torch.float32:
                        cs.check(torch.allclose(got, want,
                                                **cs.RMSNORM_F32_TOL),
                                 f"{lib} {name}: {cs.RMSNORM_F32_TOL}")
                    else:
                        err = (got.float() - want.float()).abs().max().item()
                        cs.check(err <= cs.RMSNORM_BF16_MAX_ABS,
                                 f"{lib} {name}: max abs err {err}")
            sw = s.to(dt)
            lib_ms, _ = cs.device_ms(lambda: F.rms_norm(x, (d,), sw, 1e-5))
            cs.log(f"kernel_variant {name}: F.rms_norm device ms "
                   f"{cs._fmt(lib_ms)}")
            turns(cs, use, libs, name,
                  lambda: ops.rmsnorm(x, s, eps=1e-5), ("rmsnorm_kernel",))
    use("committed")


def main(kernel, sources, check_results=True):
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_variant: torch sees no GPU; nothing was run")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip())
    {"sample_attr": sample_attr, "rmsnorm": rmsnorm}[kernel](
        cs, sources, check_results)


if __name__ == "__main__":
    args = sys.argv[1:]
    time_only = "--time-only" in args
    args = [a for a in args if a != "--time-only"]
    if len(args) < 2 or args[0] not in ("sample_attr", "rmsnorm"):
        sys.exit(__doc__)
    main(args[0], args[1:], check_results=not time_only)
