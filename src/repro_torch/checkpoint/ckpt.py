"""Fault-tolerant checkpointing: atomic, content-addressed, elastic.

Layout per step::

    <dir>/step_000123.tmp-<nonce>/   (written, fsynced)
        manifest.json                (tree structure, shapes, dtypes, crc)
        arr_00000.npy ...            (one file per leaf, np.save format)
    <dir>/step_000123/               (atomic rename on completion)
    <dir>/LATEST                     (text file, updated last)

Restore is *elastic*: leaves are saved as full logical arrays, so any
device count can reload them. Partial/corrupt checkpoints are never
visible: readers only trust directories named in LATEST whose manifest
CRCs check. Async mode snapshots device tensors to host then writes in a
thread so the train loop continues (write-behind).

The on-disk format is the JAX package's, byte for byte, so checkpoints
cross between the two packages in both directions. Trees are nests of
dicts, lists, tuples and ``None``, flattened in JAX's order (dict keys
sorted, ``None`` a node with no leaf), and the manifest's ``treedef`` is
the string JAX writes for the same tree. Leaves are torch tensors (moved
to the host on save) or numpy arrays. A ``bfloat16`` tensor, which numpy
cannot hold, is written as JAX writes ``bfloat16``: a ``'<V2'`` npy
payload of the raw 2-byte words, manifest dtype ``"bfloat16"``; restore
views such a leaf back to ``torch.bfloat16`` where the example leaf is
a bfloat16 tensor.

The manifest+CRC+rename protocol is factored into reusable pieces
(:func:`write_manifest_dir`, :func:`read_manifest_dir`,
:func:`publish_latest`) so other durable artifacts — notably the
per-host shard spills of :mod:`repro_torch.core.exchange` — share the exact
same atomicity and corruption-detection guarantees. Leaf CRCs are
computed on the in-memory ``np.save`` bytes during the write (one I/O
pass, not write-then-reread), and verified reads CRC the bytes they
just loaded for the same reason.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import threading
import uuid
import zlib
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.faults import (CorruptShardError, MissingArtifactError,
                                     TornWriteError, declare_site,
                                     resolve_plan)

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer",
           "write_manifest_dir", "read_manifest_dir", "read_manifest_meta",
           "publish_latest"]

# Injection seams this module owns (see faults.FAULT_SITES): the leaf
# codec and the manifest codec, each on both the write and read side.
_SITE_LEAF_WRITE = declare_site("ckpt.leaf_write")
_SITE_LEAF_READ = declare_site("ckpt.leaf_read")
_SITE_MANIFEST_WRITE = declare_site("ckpt.manifest_write")
_SITE_MANIFEST_READ = declare_site("ckpt.manifest_read")

_BF16 = "bfloat16"


# -- trees ---------------------------------------------------------------------

class TreeDef:
    """The structure of a flattened tree: ``str()`` is JAX's ``PyTreeDef``
    string for the same tree, :meth:`unflatten` rebuilds it."""

    def __init__(self, node):
        self._node = node       # "*" | None | ("dict", keys, kids) | (type, kids)

    def __str__(self) -> str:
        return f"PyTreeDef({_render(self._node)})"

    def unflatten(self, leaves: Sequence[Any]):
        it = iter(leaves)
        out = _build(self._node, it)
        if next(it, _END) is not _END:
            raise ValueError("more leaves than the tree has")
        return out


_END = object()


def _node_of(tree, leaves: list):
    if tree is None:
        return None
    t = type(tree)
    if t is dict:
        keys = sorted(tree)                      # JAX's order
        return ("dict", tuple(keys),
                tuple(_node_of(tree[k], leaves) for k in keys))
    if t is list or t is tuple:
        return (t, tuple(_node_of(v, leaves) for v in tree))
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic,
                         int, float, complex)):
        leaves.append(tree)
        return "*"
    raise TypeError(f"checkpoint trees are nests of dicts, lists, tuples "
                    f"and None over tensor, array or scalar leaves; got "
                    f"{t.__name__}")


def _render(node) -> str:
    if node == "*":
        return "*"
    if node is None:
        return "None"
    if node[0] == "dict":
        _, keys, kids = node
        return "{" + ", ".join(f"{k!r}: {_render(c)}"
                               for k, c in zip(keys, kids)) + "}"
    t, kids = node
    body = ", ".join(_render(c) for c in kids)
    if t is list:
        return f"[{body}]"
    return f"({body},)" if len(kids) == 1 else f"({body})"


def _build(node, it):
    if node == "*":
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("fewer leaves than the tree has")
        return leaf
    if node is None:
        return None
    if node[0] == "dict":
        _, keys, kids = node
        return {k: _build(c, it) for k, c in zip(keys, kids)}
    t, kids = node
    return t(_build(c, it) for c in kids)


def _flatten(tree: Any):
    leaves: list = []
    treedef = TreeDef(_node_of(tree, leaves))
    return leaves, treedef


# -- leaves --------------------------------------------------------------------

def _host(leaf) -> tuple[np.ndarray, str]:
    """(host array, manifest dtype) of one leaf. A bfloat16 tensor becomes
    a ``V2`` view of its raw words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _npy_bytes(arr: np.ndarray, dtype: str) -> bytes:
    buf = io.BytesIO()
    if dtype == _BF16:
        # np.save of JAX's bfloat16 writes descr '<V2'; a plain V2 array
        # would write '|V2'. Same header, same payload: same bytes, CRC.
        np.lib.format.write_array_header_1_0(buf, {
            "descr": "<V2", "fortran_order": False,
            "shape": tuple(arr.shape)})
        buf.write(np.ascontiguousarray(arr).tobytes())
    else:
        np.save(buf, arr)
    return buf.getvalue()


def _write_leaf(dirpath: str, fname: str, arr: np.ndarray,
                dtype: str) -> int:
    """Serialize one leaf (host array, manifest dtype: see :func:`_host`)
    to ``<dirpath>/<fname>``; returns its CRC32.

    ``np.save`` targets an in-memory buffer so the CRC covers exactly the
    bytes written without re-reading the file from disk.
    """
    data = _npy_bytes(arr, dtype)
    fp = os.path.join(dirpath, fname)
    crc = zlib.crc32(data)
    plan = resolve_plan(None)
    if plan is not None:
        # Storage-layer rot model: the CRC covers the *intended* bytes,
        # the disk holds the corrupted ones, so verified reads detect it.
        data = plan.corrupt_bytes(fp, data, "write")
    with open(fp, "wb") as f:
        f.write(data)
    return crc


def _expected_leaf_bytes(meta: dict) -> int | None:
    """Lower bound on the leaf's npy byte length (payload, sans header)."""
    try:
        itemsize = (2 if meta["dtype"] == _BF16
                    else np.dtype(meta["dtype"]).itemsize)
        n = 1
        for s in meta["shape"]:
            n *= int(s)
        return n * itemsize
    except (KeyError, TypeError, ValueError):
        return None


def _read_leaf(dirpath: str, meta: dict) -> np.ndarray:
    """Load + CRC-verify one leaf described by a manifest entry.

    Failure typing: a missing or short file is a :class:`TornWriteError`
    (the writer — or the storage layer — lost bytes after publication);
    present-but-wrong bytes are a :class:`CorruptShardError`. Both are
    ``IOError`` subclasses, so callers' transient-race retry loops are
    unchanged.
    """
    try:
        fp = os.path.join(dirpath, meta["file"])
    except (KeyError, TypeError) as e:
        raise CorruptShardError(
            f"malformed leaf entry in {dirpath}/manifest.json: {e!r}") from e
    try:
        with open(fp, "rb") as f:
            data = f.read()
    except FileNotFoundError as e:
        raise TornWriteError(f"missing leaf {fp} (torn write)") from e
    plan = resolve_plan(None)
    if plan is not None:
        data = plan.corrupt_bytes(fp, data, "read")
    try:
        want_crc = meta["crc32"]
    except (KeyError, TypeError) as e:
        raise CorruptShardError(
            f"malformed leaf entry for {fp}: {e!r}") from e
    if zlib.crc32(data) != want_crc:
        expect = _expected_leaf_bytes(meta)
        if expect is not None and len(data) < expect:
            raise TornWriteError(
                f"truncated leaf {fp}: {len(data)} bytes < {expect} "
                f"expected (torn write)")
        raise CorruptShardError(f"CRC mismatch in {fp} (corrupt checkpoint)")
    try:
        return np.load(io.BytesIO(data))
    except Exception as e:
        raise CorruptShardError(f"undecodable leaf {fp}: {e}") from e


def _like(arr: np.ndarray, example):
    """A restored leaf in the example leaf's kind: a tensor on the
    example's device for a tensor example (bfloat16 from its raw words),
    else the numpy array as loaded."""
    if not isinstance(example, torch.Tensor):
        return arr
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        if example.dtype != torch.bfloat16:
            raise ValueError(f"a bfloat16 leaf cannot restore into a "
                             f"{example.dtype} tensor")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(example.device)


def write_manifest_dir(final: str, arrays: Sequence[Any],
                       meta: dict | None = None) -> str:
    """Atomically publish ``arrays`` + manifest under directory ``final``.

    The shared protocol: write into ``<final>.tmp-<nonce>/``, fsync the
    manifest, then atomically rename. A crashed writer leaves only a
    ``.tmp-`` directory, which readers never look at. ``meta`` is merged
    into the manifest (callers stash step numbers, treedefs, shard ids).
    ``arrays`` holds numpy arrays or tensors.
    """
    tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp, exist_ok=True)
    manifest: dict = dict(meta or {})
    manifest["leaves"] = []
    for i, leaf in enumerate(arrays):
        arr, dtype = _host(leaf)
        fname = f"arr_{i:05d}.npy"
        crc = _write_leaf(tmp, fname, arr, dtype)
        manifest["leaves"].append({
            "file": fname, "shape": list(arr.shape),
            "dtype": dtype, "crc32": crc})
    mf = os.path.join(tmp, "manifest.json")
    mdata = json.dumps(manifest).encode()
    plan = resolve_plan(None)
    if plan is not None:
        mdata = plan.corrupt_bytes(mf, mdata, "write")
    with open(mf, "wb") as f:
        f.write(mdata)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def read_manifest_dir(d: str) -> tuple[list[np.ndarray], dict]:
    """Load (arrays, manifest) from a published dir, verifying every CRC."""
    manifest = read_manifest_meta(d)
    arrays = [_read_leaf(d, meta) for meta in manifest["leaves"]]
    return arrays, manifest


def read_manifest_meta(d: str) -> dict:
    """Manifest JSON of a published dir alone — no array I/O.

    The cheap half of the protocol: delta-chain walkers and shard-meta
    readers (:mod:`repro_torch.core.exchange`) inspect epoch linkage and
    caller ``extra`` state without paying for (or CRC-checking) the
    leaves.
    """
    fp = os.path.join(d, "manifest.json")
    with open(fp, "rb") as f:
        data = f.read()
    plan = resolve_plan(None)
    if plan is not None:
        data = plan.corrupt_bytes(fp, data, "read")
    try:
        manifest = json.loads(data.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CorruptShardError(f"unparseable manifest {fp}: {e}") from e
    if not isinstance(manifest, dict) or "leaves" not in manifest:
        raise CorruptShardError(f"manifest {fp} lacks a leaves table")
    return manifest


def publish_latest(path: str, step: int) -> None:
    """Atomically point ``<path>/LATEST`` at ``step`` (fsynced tmp+rename)."""
    with open(os.path.join(path, "LATEST.tmp"), "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(path, "LATEST.tmp"),
               os.path.join(path, "LATEST"))


def save(path: str, step: int, tree: Any) -> str:
    """Blocking atomic save. Returns the final directory."""
    leaves, treedef = _flatten(tree)
    final = os.path.join(path, f"step_{step:09d}")
    write_manifest_dir(final, leaves,
                       meta={"step": step, "treedef": str(treedef)})
    publish_latest(path, step)
    return final


def latest_step(path: str) -> int | None:
    try:
        with open(os.path.join(path, "LATEST")) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return None


def restore(path: str, example_tree: Any, step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``example_tree``: tensor leaves come
    back as tensors on the example leaf's device, other leaves as numpy
    arrays. Verifies CRCs."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise MissingArtifactError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_meta = manifest["leaves"]
    example_leaves, treedef = _flatten(example_tree)
    if len(example_leaves) != len(leaves_meta):
        raise ValueError(
            f"checkpoint has {len(leaves_meta)} leaves; expected "
            f"{len(example_leaves)} (structure changed?)")
    out = []
    for meta, ex in zip(leaves_meta, example_leaves):
        arr = _read_leaf(d, meta)
        if list(arr.shape) != list(_shape(ex)):
            raise ValueError(
                f"shape mismatch for {meta['file']}: {arr.shape} vs "
                f"{_shape(ex)}")
        out.append(_like(arr, ex))
    return treedef.unflatten(out), step


def _shape(leaf) -> tuple[int, ...]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return np.shape(leaf)


def _snapshot(tree):
    """The tree with every leaf copied to the host (tensors stay tensors,
    so bfloat16 survives; everything else becomes a numpy array)."""
    leaves, treedef = _flatten(tree)
    return treedef.unflatten(
        [x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
         else np.asarray(x) for x in leaves])


class AsyncCheckpointer:
    """Write-behind checkpointing: snapshot to host, write in a thread."""

    def __init__(self, path: str, *, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(path, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree: Any):
        self.wait()                                   # one in flight
        host_tree = _snapshot(tree)

        def _write():
            save(self.path, step, host_tree)
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.path)
            if n.startswith("step_") and not n.count(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:09d}"),
                          ignore_errors=True)
