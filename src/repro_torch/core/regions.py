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

:func:`mark_in_jit` is the counterpart of the reference's in-graph,
ordered marker store. On a CPU session it stores at once, which is
already in order; on a CUDA session the marker is a
:class:`~repro_torch.core.stream_marker.StreamMarker` and the store is
queued on the current CUDA stream, so it fires when the GPU reaches it:
samples see the region whose device work is running, not the one being
queued.

:func:`opaque` is the counterpart of a compiled step. The reference runs
the model's ``region`` calls only while ``jax.jit`` traces a step, so on
every later call a sample lands in the region around the step (a serving
phase), never in a layer. The port runs the model eagerly: the serving
engine runs each step inside ``opaque()``, where a nested ``region`` only
labels the trace and leaves the marker alone.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

from torch.profiler import record_function

from repro_torch.core.sampler import RegionMarker
from repro_torch.core.stream_marker import StreamMarker

__all__ = ["RegionRegistry", "region", "registry", "profiling_session",
           "mark_in_jit", "opaque"]


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

    It marks in execution order, as the reference's ordered callback
    does: a session on the GPU holds a
    :class:`~repro_torch.core.stream_marker.StreamMarker`, and the store
    is queued on the current CUDA stream behind the work issued before
    this call (it raises if CUDA refuses it); a CPU session's marker
    stores at once. Meant for host-mode validation runs, as the
    reference's in-graph store is.
    """
    rid = registry.intern(name)
    m = _active_marker
    if m is not None and _in_jit_marking:
        if isinstance(m, StreamMarker):
            m.set_in_stream(rid)
        else:
            m.set(rid)
    return dep


_region_stack = threading.local()
_opaque_depth = threading.local()


@contextlib.contextmanager
def opaque() -> Iterator[None]:
    """Run a compiled step's body: every :func:`region` entered inside the
    block, on this thread, labels the trace (``record_function``) and
    never stores into the marker, as the reference's regions do on every
    call of a jitted step after its trace. Regions outside the block keep
    marking."""
    prev = getattr(_opaque_depth, "n", 0)
    _opaque_depth.n = prev + 1
    try:
        yield
    finally:
        _opaque_depth.n = prev


@contextlib.contextmanager
def region(name: str) -> Iterator[int]:
    """Declare a region. Cheap always; marker store only inside a session.

    Nested regions restore the *parent* region id on exit (a stack), so
    host time spent inside an outer region but after an inner one is
    attributed to the outer region, like a PC returning to the caller's
    basic block.
    """
    rid = registry.intern(name)
    m = (_active_marker
         if not (_in_jit_marking or getattr(_opaque_depth, "n", 0))
         else None)
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
