"""window_pairs_per_s: the sample pairs compared by the window's completed
calls (the traffic's pairs rule, n(n-1)/2 a call for all2all) over the
window, from its start to the last call's end (host clock).  It is the
rate a user of back-to-back calls waits on, read per layer: the shared
host moves it by more than any end-to-end bound may allow."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return len(run.calls) * run.pairs_per_call / run.window_s
