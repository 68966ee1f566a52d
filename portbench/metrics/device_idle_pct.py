"""device_idle_pct: the share of the traced window, in %, in which no
kernel, copy or set ran on the card (torch.profiler's CUDA activity, the
union of their intervals: devtrace.summarize)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
