"""Region marks in CUDA stream order, for ``mark_in_jit`` on the GPU.

The reference stores an in-graph marker through an ordered host callback,
so a sample sees the region whose computation is running. PyTorch runs
eagerly and the host queues work ahead of the GPU, so a store made when
the host reaches ``mark_in_jit`` would attribute queueing, not running.
:class:`StreamMarker` queues the store on the current CUDA stream
instead (``cudaLaunchHostFunc``, ``kernels/stream_marker/
stream_marker.cu``): it fires once the work queued before it has
finished and before the work queued after it starts.

The marker's value lives in a C slot that the queued host function writes
from CUDA's callback thread; no Python runs there, so it takes no
interpreter lock and cannot deadlock against a thread that waits on the
stream. The library is built on first use (``build/kernels/``); if it
cannot be built or a store cannot be queued, this raises — it never falls
back to storing in host order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.sampler import RegionMarker

__all__ = ["StreamMarker"]


@functools.cache
def _library():
    """The built library with its C signatures declared (built and loaded
    on first use, never at import)."""
    from repro_torch.kernels import _build
    lib = _build.load("stream_marker")
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, args, res in (("sm_slot_new", [], P),
                            ("sm_slot_release", [P], None),
                            ("sm_slot_get", [P], I),
                            ("sm_slot_set", [P, I], None),
                            ("sm_mark", [P, I, P, I], I),
                            ("sm_error_string", [I], ctypes.c_char_p)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


class StreamMarker(RegionMarker):
    """A :class:`RegionMarker` whose value is a C slot: :meth:`set` stores
    now (host order), :meth:`set_in_stream` queues the store on the
    device's current CUDA stream (stream order). The sampler reads
    ``value`` as it reads any marker's. ``queued`` counts the stores
    queued on a stream."""

    __slots__ = ("_lib", "_slot", "device", "queued")

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"StreamMarker needs a CUDA device, got "
                             f"{self.device}")
        self._lib = _library()
        self._slot = self._lib.sm_slot_new()
        if not self._slot:
            raise MemoryError("stream marker: no memory for its slot")
        self.queued = 0
        super().__init__()

    @property
    def value(self) -> int:
        return self._lib.sm_slot_get(self._slot)

    @value.setter
    def value(self, region_id: int) -> None:
        self._lib.sm_slot_set(self._slot, int(region_id))

    def set_in_stream(self, region_id: int) -> None:
        """Queue the store of ``region_id`` on the current stream of
        ``self.device``; raises if CUDA refuses it."""
        index = (self.device.index if self.device.index is not None
                 else torch.cuda.current_device())
        stream = torch.cuda.current_stream(index).cuda_stream
        err = self._lib.sm_mark(self._slot, int(region_id), stream, index)
        if err != 0:
            raise RuntimeError("stream marker: cudaLaunchHostFunc failed: "
                               + self._lib.sm_error_string(err).decode())
        self.queued += 1

    def __del__(self):
        slot = getattr(self, "_slot", None)
        if slot:
            self._lib.sm_slot_release(slot)
            self._slot = None
