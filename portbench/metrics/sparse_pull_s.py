"""sparse_pull_s: seconds a call of the card's sparse pull, the count
filter and the copies of its counts and of the survivor tiles to the host
(last_stats' filter_s + pull_s of the streamed route, CUDA events), the
mean over the window's calls that took it.  None where no call took the
sparse pull."""


def read(run):
    vals = [c["stats"]["filter_s"] + c["stats"].get("pull_s", 0.0)
            for c in run.calls
            if "sparse_pull" in c["stats"] and "filter_s" in c["stats"]]
    return sum(vals) / len(vals) if vals else None
