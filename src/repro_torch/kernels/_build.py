"""Build the port's CUDA kernels from the repository's sources.

Each kernel is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` into a shared library for ``sm_90a`` and loaded with
:mod:`ctypes`. A source that includes PyTorch's headers
(``torch.utils.cpp_extension.load``) takes minutes to compile; a plain C
interface takes seconds, and every fresh machine builds anew, so the
kernels keep PyTorch out of their sources: the Python wrapper passes
``data_ptr()`` integers and the current stream.

Libraries land in ``build/kernels/`` at the repository root (git-ignored),
named by a hash of the source and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. Nothing is built at import
time: :func:`load` builds on first use, and :func:`build` starts one
``nvcc`` per source, all at once, for callers that want every kernel
ready up front. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load"]

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _source(name: str) -> Path:
    return _KERNELS_DIR / name / f"{name}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels are built "
                       "from source on the machine with the GPU")


def _target(name: str) -> Path:
    digest = hashlib.sha256(_source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names) -> dict[str, Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns each kernel's library path."""
    out = {name: _target(name) for name in names}
    todo = [n for n, p in out.items() if not p.exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out[name])    # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is not yet."""
    return ctypes.CDLL(str(build([name])[name]))
