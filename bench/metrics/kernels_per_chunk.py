"""Kernels launched per chunk over one traced profile (copies and sets
not counted)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["kernels"] or not t.get("chunks"):
        return None
    return t["kernels"] / t["chunks"]
