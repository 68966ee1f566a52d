"""gram_roofline_pct: the Gram kernels' share of their roofline, in %:
the least time an H100 needs for the lower-triangle Gram of the loaded
database (roofline.gram_bound_s, from its patterns and samples alone)
over the mean seconds a call that the Gram kernels took (last_stats'
gram_s, CUDA events around each launch).  Published peaks at 700 W."""

from portbench import roofline


def read(run):
    vals = [c["stats"]["gram_s"] for c in run.calls
            if c["stats"].get("gram_s")]
    if not vals or "P" not in run.db:
        return None
    bound = roofline.gram_bound_s(run.db["P"], run.db["S"])
    return 100.0 * bound / (sum(vals) / len(vals))
