"""What the profiler's entry costs beyond its device pipeline, per
profile: the wall of one entry call minus the wall of the entry's own
call into the device pipeline, timed by a span of the benchmark's around
that call (timeline upload, read-back, estimator)."""


def read(ctx):
    p = ctx.get("probe")
    if not p or "pipeline_s" not in p:
        return None
    return (p["entry_s"] - p["pipeline_s"]) * 1e3
