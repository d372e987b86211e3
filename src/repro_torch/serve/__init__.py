"""Serving: the continuous-batching engine with per-phase energy
accounting (``engine``), admission and overload control (``scheduler``)
and crash recovery (``recovery``). Port of ``src/repro/serve``."""
