"""The ``sample_attr`` fold's share of its roofline over one traced
profile: the least time of the fold's work (``roofline.
fold_least_seconds``, from the reference's count of the samples, lanes
and carry rows each chunk touches) over the device time of the kernels
that implement it, named below. None when the trace holds none of them.
The card's power limit is in the result's ``device``."""

import roofline
import tracing

KERNELS = ("sa_tile_table", "sa_region_merge")


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    spent = tracing.kernel_seconds(t, KERNELS)
    if spent <= 0:
        return None
    least, _ = roofline.fold_least_seconds(ctx["fold"], ctx["device"]["kind"])
    return 100.0 * least / spent
