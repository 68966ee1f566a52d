"""writer_s: seconds a call in the CLI's row loop and CSV writer
(cli/consoles._emit_matrix_row, utils/csvio.py, utils/num2str.py,
utils/filters.py), the mean over the window's calls of the streamed
route's handler_s (ops/device_a2a.last_stats, host clock)."""


def read(run):
    vals = [c["stats"]["handler_s"] for c in run.calls
            if "handler_s" in c["stats"]]
    return sum(vals) / len(vals) if vals else None
