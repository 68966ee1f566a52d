"""filter_roofline_pct: the count filter's share of its roofline, in %:
the least time an H100 needs to read the lower triangle's counts once and
write one count per tile row and column (sparse_roofline.filter_bound_s,
from the number of samples alone) over the mean seconds a call of the
filter (last_stats' filter_s, CUDA events around each filter_colsum
launch alone; the copy of its counts to the host is in pull_s).  Published
bandwidth at 700 W.  None where no call took the sparse pull."""

from portbench import sparse_roofline


def read(run):
    vals = [c["stats"]["filter_s"] for c in run.calls
            if "sparse_pull" in c["stats"] and c["stats"].get("filter_s")]
    if not vals or "S" not in run.db:
        return None
    return 100.0 * sparse_roofline.filter_bound_s(run.db["S"]) \
        / (sum(vals) / len(vals))
