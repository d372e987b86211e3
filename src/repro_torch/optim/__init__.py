"""Optimizer (AdamW, schedules, clipping) and int8 gradient compression
with error feedback. Port of ``src/repro/optim``."""
