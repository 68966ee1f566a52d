"""fill_push_s: seconds a call that the device tier spends filling the
bit-packed pattern groups on the host and copying them to the card
(ops/device_a2a._Packer), the mean over the window's calls of last_stats'
fill_s + push_s (host clock)."""


def read(run):
    vals = [c["stats"]["fill_s"] + c["stats"]["push_s"] for c in run.calls
            if "fill_s" in c["stats"] and "push_s" in c["stats"]]
    return sum(vals) / len(vals) if vals else None
