"""tiles_pulled_pct: the share, in %, of the 128 x 128 tiles of the padded
count square that the sparse pull brings to the host (the program's
counters device.tiles_pulled over device.tiles_total, each tile once, a
stripe pulled whole counting all of its tiles), summed over the window's
calls' records.  None where no call took the sparse pull."""

from portbench import records


def read(run):
    recs = [r["counters"] for r in records.window_records(run)
            if r["counters"].get("device.tiles_total")]
    if not recs:
        return None
    return 100.0 * sum(c["device.tiles_pulled"] for c in recs) \
        / sum(c["device.tiles_total"] for c in recs)
