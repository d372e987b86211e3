"""Build the port's CUDA kernels from the repository's sources.

Each kernel is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` into a shared library for ``sm_90a`` and loaded with
:mod:`ctypes`. A source that includes PyTorch's headers
(``torch.utils.cpp_extension.load``) takes minutes to compile; a plain C
interface takes seconds, and every fresh machine builds anew, so the
kernels keep PyTorch out of their sources: the Python wrapper passes
``data_ptr()`` integers and the current stream.

Libraries land in ``build/kernels/`` at the repository root (git-ignored),
named by a hash of the flags and of every source file in the kernel's
directory (the ``.cu`` and the ``.cuh`` headers it includes) and of each
header it includes from another kernel's directory, so an edited
source or header is rebuilt and an unchanged one is loaded as it is. Nothing is built at import
time: :func:`load` builds on first use, and :func:`build` starts one
``nvcc`` per source, all at once, for callers that want every kernel
ready up front. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load"]

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


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


def _inputs(name: str) -> list[Path]:
    """Every file the build of ``name`` reads from the repository: its
    ``.cu`` and each ``.cu``/``.cuh`` beside it, then the headers they
    include (``#include "..."``) from another kernel's directory, each
    list in a fixed order."""
    d = _source(name).parent
    own = sorted(p.resolve() for p in d.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    seen, todo, shared = set(own), list(own), []
    while todo:
        src = todo.pop()
        for inc in _INCLUDE.findall(src.read_bytes()):
            path = (src.parent / inc.decode()).resolve()
            if path not in seen and path.is_file():
                seen.add(path)
                shared.append(path)
                todo.append(path)
    return own + sorted(shared)


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _inputs(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


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
