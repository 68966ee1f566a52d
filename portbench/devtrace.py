"""The traced run's device timeline and the benchmark's host spans.

One torch.profiler session (CPU and CUDA activity) covers the window: a
second session in one process has been seen to hold no kernel events.  The
device is busy where a kernel, copy or set runs; the union of those
intervals inside the window is busy_s.  The benchmark's own host spans
(perf_counter seconds: the database load, pattern fill and push, the
writer's bursts of rows, each call) are placed on the trace's clock by the
window's own annotation, and each idle gap is labelled with the innermost
span that covers at least half of it.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"
TOP = 10
#: rows of the writer closer than this belong to one burst
BURST_GAP_S = 1e-3


class Spans:
    """Host spans (name, start, end) on the perf_counter clock."""

    def __init__(self):
        self.items: list = []

    def wrap(self, fn, name: str, merge: bool = False):
        """fn, recording a span of each call; with merge, calls that follow
        within BURST_GAP_S extend the last span (the writer's rows)."""
        items = self.items

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                if merge and items and items[-1][0] == name \
                        and t0 - items[-1][2] < BURST_GAP_S:
                    items[-1] = (name, items[-1][1], t1)
                else:
                    items.append((name, t0, t1))
        return wrapped

    def durations(self, name: str) -> list:
        return [t1 - t0 for n, t0, t1 in self.items if n == name]


class DeviceTrace:
    """The profiler session over the window (enter at the window's start,
    exit at its end); summary() reads it."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._window = record_function(WINDOW)
        self.t0 = time.perf_counter()
        self._window.__enter__()
        self._sync = torch.cuda.synchronize
        return self

    def __exit__(self, *exc):
        self._sync()
        self._window.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def events(self) -> list:
        fd, path = tempfile.mkstemp(prefix="portbench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.unlink(path)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list, window_t0: float, spans: Spans) -> dict | None:
    """busy_s, window_s, the device operations that took most time and the
    longest idle gaps, each labelled by a host span ("harness" where none
    overlaps it); None without the window's annotation
    or without any device event in it."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation" and "dur" in e]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    offset_us = w0 - window_t0 * 1e6
    dev = []
    by_name: dict = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) / 1e6
    if not dev:
        return None
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    host = [(n, t0 * 1e6 + offset_us, t1 * 1e6 + offset_us)
            for n, t0, t1 in spans.items]
    gaps = []
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    labelled = []
    for a, b in gaps:
        # the innermost span that covers at least half of the gap (spans
        # nest: a call holds its load, fill and writer), else the span that
        # covers most of it
        over = [(min(b, h1) - max(a, h0), h1 - h0, n) for n, h0, h1 in host]
        over = [o for o in over if o[0] > 0]
        half = [o for o in over if 2 * o[0] >= b - a]
        label = min(half, key=lambda o: o[1])[2] if half else \
            max(over)[2] if over else "harness"
        labelled.append([label, (b - a) / 1e6])
    labelled.sort(key=lambda g: -g[1])
    idle_by: dict = {}
    for label, s in labelled:
        idle_by[label] = idle_by.get(label, 0.0) + s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n, s] for n, s in ops[:TOP]],
            "idle_gaps": labelled[:TOP],
            "idle_by_span": sorted(idle_by.items(), key=lambda kv: -kv[1])}
