"""Host wall per chunk of the device pipeline's chunk loop: the wall of
the entry's call into the pipeline (the benchmark's span) over its
chunks."""


def read(ctx):
    p = ctx.get("probe")
    if not p or not p.get("chunks"):
        return None
    return p["pipeline_s"] / p["chunks"] * 1e3
