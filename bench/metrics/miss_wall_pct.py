"""Share of the combination pipeline's wall spent in its miss path
(host replay, interning, table rebuild, carry growth): the pipeline's own
``miss_seconds`` counter over the wall of the same call, both from the
entry's call into ``run_combo_pipeline``. None on the region path, which
has no miss path."""


def read(ctx):
    p = ctx.get("probe")
    if not p or "miss_seconds" not in p["stats"] or not p.get("pipeline_s"):
        return None
    return 100.0 * p["stats"]["miss_seconds"] / p["pipeline_s"]
