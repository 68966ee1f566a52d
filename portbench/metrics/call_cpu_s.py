"""call_cpu_s: CPU seconds a call of the measuring process, user and
system over all its threads (getrusage around each call), the mean over
the window's calls.  Most of it is the row loop and writer; unlike the
calls' walls it does not count time the process waits for a core on a
shared host."""


def read(run):
    vals = [c["cpu_s"] for c in run.calls if "cpu_s" in c]
    return sum(vals) / len(vals) if vals else None
