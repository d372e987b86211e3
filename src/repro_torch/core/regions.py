"""Region registry and markers — named sub-computations of a step.

A *region* is a named sub-computation of a step (``attn``, ``ffn``,
``lm_head``...). Regions are declared where the model is built:

    with regions.region("attn"):
        h = ...

This does three things:
  1. wraps the computation in ``torch.profiler.record_function`` so the
     region name labels the host range in a profiler trace, and the device
     kernels launched inside it are attributed to it (the counterpart of
     the reference's ``jax.named_scope``);
  2. when a profiling session is active, updates the shared
     :class:`~repro_torch.core.sampler.RegionMarker` so the host control
     thread can sample the currently-executing region;
  3. registers the region (stable id assignment) for reports.

When no session is active the context manager is a plain
``record_function``, which costs nothing measurable unless a profiler is
recording.

:func:`mark_in_jit` is the counterpart of the reference's in-graph
marker store. The port runs eagerly, so it stores the marker at the
point where the host issues the call: on the GPU that is when the
following work is queued, not when it runs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

from torch.profiler import record_function

from repro_torch.core.sampler import RegionMarker

__all__ = ["RegionRegistry", "region", "registry", "profiling_session",
           "mark_in_jit"]


class RegionRegistry:
    """Process-wide region-name ↔ id mapping (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._name_to_id: dict[str, int] = {"<other>": 0}
        self._names: list[str] = ["<other>"]

    def intern(self, name: str) -> int:
        with self._lock:
            rid = self._name_to_id.get(name)
            if rid is None:
                rid = len(self._names)
                self._name_to_id[name] = rid
                self._names.append(name)
            return rid

    @property
    def names(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(self._names)

    def name_of(self, rid: int) -> str:
        return self._names[rid]

    def reset(self) -> None:
        with self._lock:
            self._name_to_id = {"<other>": 0}
            self._names = ["<other>"]


registry = RegionRegistry()

# Active profiling marker (None ⇒ regions only label the trace).
_active_marker: RegionMarker | None = None
_in_jit_marking = False


@contextlib.contextmanager
def profiling_session(marker: RegionMarker, *, jit_marking: bool = False
                      ) -> Iterator[None]:
    """Activates host-mode marking: every :func:`region` entered inside
    the block stores its id into ``marker``. With ``jit_marking`` the
    stores come from :func:`mark_in_jit` calls instead, and ``region``
    only labels the trace (validation runs only, as in the reference)."""
    global _active_marker, _in_jit_marking
    prev, prev_jit = _active_marker, _in_jit_marking
    _active_marker, _in_jit_marking = marker, jit_marking
    try:
        yield
    finally:
        _active_marker, _in_jit_marking = prev, prev_jit


def mark_in_jit(name: str, dep=None):
    """Store ``name``'s region id into the active marker (sessions with
    ``jit_marking=True`` only; a no-op otherwise). Returns ``dep``
    unchanged so callers can thread it for ordering, as in the reference.

    It marks host issue order: PyTorch runs eagerly, so the store happens
    when this line runs, which on the GPU is when the work after it is
    queued, not when that work executes. Meant for host-mode validation
    runs, as the reference's in-graph store is; there is no device-side
    callback behind it.
    """
    rid = registry.intern(name)
    if _active_marker is not None and _in_jit_marking:
        _active_marker.set(rid)
    return dep


_region_stack = threading.local()


@contextlib.contextmanager
def region(name: str) -> Iterator[int]:
    """Declare a region. Cheap always; marker store only inside a session.

    Nested regions restore the *parent* region id on exit (a stack), so
    host time spent inside an outer region but after an inner one is
    attributed to the outer region, like a PC returning to the caller's
    basic block.
    """
    rid = registry.intern(name)
    m = _active_marker if not _in_jit_marking else None
    if m is not None:
        stack = getattr(_region_stack, "s", None)
        if stack is None:
            stack = _region_stack.s = [0]
        stack.append(rid)
        m.set(rid)
    with record_function(name):
        yield rid
    if m is not None:
        stack = _region_stack.s
        stack.pop()
        m.set(stack[-1])
