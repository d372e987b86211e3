"""Token data pipeline (numpy; a copy of ``src/repro/data``)."""
