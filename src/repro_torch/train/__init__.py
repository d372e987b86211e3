"""The train step (loss → grad → compress → AdamW) and the
fault-tolerant training loop. Port of ``src/repro/train``."""
