"""load_s: seconds a call in the database load (io/dbfile.load_db), the
mean over the window's calls of the benchmark's own span around it
(recorded in the traced run only, host clock)."""


def read(run):
    vals = run.spans.durations("load")
    return sum(vals) / len(vals) if vals else None
