"""The port's tracing: one record per CLI call, spans and counters at the
layer boundaries inside it, and the card's own seconds from CUDA events.

cli/main.main opens call(mode) around the mode's runner.  Inside it:

* span(name) times a layer's work, summed per name: how often (n), wall
  seconds, self seconds (wall less the spans opened inside it) and the
  calling thread's CPU seconds (time.thread_time).  A dotted name is a
  part of the span named before its last dot and is always opened inside
  it (load.read inside load).  While a
  torch.profiler session is active the span is also a
  torch.profiler.record_function label of the same name, so the program's
  spans lie on the device trace's clock; this module never imports torch
  itself, and makes no label in a process that has not.
* rows() is the span of one burst of CSV rows.  The row writer sums its
  format and write seconds per row into `row_sums` (three reads of the
  clock a row, nothing allocated), and a sparse row's filter seconds (one
  read more); the span hands them to the record as rows.format,
  rows.write and rows.filter (n and wall alone) and counts the rows.
* add(name, n) adds to a counter.
* Events(dev) times spans of CUDA work by events on the card; its
  seconds() adds each event pair to the record once, as device.<name>
  (the name less its _s).

The record (a dict) holds the mode, t0 and t1 on time.perf_counter, the
exit code, the spans, counters and device seconds, and unattributed_s:
the call's wall less the spans opened at its top level on its thread.
history() returns the last HISTORY records.  collect() sums the spans,
counters and device seconds opened inside it, with or without a call:
the device routes' last_stats read theirs from it.
"""

from __future__ import annotations

import collections
import contextlib
import sys
import threading
import time

#: closed records kept for history()
HISTORY = 64
#: a span's numbers, in the order _Sums.spans keeps them
FIELDS = ("n", "wall_s", "self_s", "cpu_s")

_history: collections.deque = collections.deque(maxlen=HISTORY)
#: the open sums, outermost first: the call's record, then collect()s
_open: list = []
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _label(name: str):
    """An entered torch.profiler.record_function(name) while a profiler
    session is active, else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    label = torch.profiler.record_function(name)
    label.__enter__()
    return label


class _Sums:
    """Spans ({name: [FIELDS]}), counters and device seconds summed by
    name from the moment it opens; covered_s sums the walls of the spans
    opened at its top level on its own thread."""

    def __init__(self):
        self.spans: dict = {}
        self.counters: dict = {}
        self.device: dict = {}
        self.thread = threading.get_ident()
        self.depth = len(_stack())
        self.covered_s = 0.0

    def wall(self, name: str) -> float:
        s = self.spans.get(name)
        return s[1] if s else 0.0

    def _add_span(self, name: str, vals: tuple, thread: int,
                  depth: int) -> None:
        s = self.spans.get(name)
        if s is None:
            self.spans[name] = list(vals)
        else:
            for i, v in enumerate(vals):
                s[i] += v
        if thread == self.thread and depth == self.depth:
            self.covered_s += vals[1]


class _Span:
    __slots__ = ("name", "wall", "child", "t0", "c0", "label")

    def __init__(self, name: str):
        self.name = name
        self.wall = 0.0
        self.child = 0.0

    def __enter__(self):
        self.label = _label(self.name)
        _stack().append(self)
        self.c0 = time.thread_time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        c1 = time.thread_time()
        stack = _stack()
        stack.pop()
        if self.label is not None:
            self.label.__exit__(*exc)
        self.wall = wall = t1 - self.t0
        if stack:
            stack[-1].child += wall
        _close(self.name, (1, wall, wall - self.child, c1 - self.c0),
               len(stack))
        return False


def _close(name: str, vals: tuple, depth: int) -> None:
    thread = threading.get_ident()
    for s in _open:
        s._add_span(name, vals, thread, depth)


def span(name: str) -> _Span:
    """A context manager timing `name` into the open record and sums; the
    object's .wall holds its wall seconds once it has closed."""
    return _Span(name)


def add(name: str, n) -> None:
    """Adds n to the counter `name` of the open record and sums."""
    for s in _open:
        s.counters[name] = s.counters.get(name, 0) + n


class _RowSums:
    """The row writer's seconds and counts since the last rows span
    closed: every row's format and write, a sparse row's filter."""

    __slots__ = ("format_s", "write_s", "n", "filter_s", "n_filter")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.format_s = self.write_s = self.filter_s = 0.0
        self.n = self.n_filter = 0


#: summed into by the row writer (cli/consoles._emit_matrix_row)
row_sums = _RowSums()


class _Rows(_Span):
    __slots__ = ()

    def __exit__(self, *exc):
        rs = row_sums
        # the parts are the rows span's children, timed by the writer
        self.child += rs.format_s + rs.write_s + rs.filter_s
        super().__exit__(*exc)
        if rs.n:
            depth = len(_stack()) + 1
            _close("rows.format", (rs.n, rs.format_s, rs.format_s), depth)
            _close("rows.write", (rs.n, rs.write_s, rs.write_s), depth)
            if rs.n_filter:
                _close("rows.filter",
                       (rs.n_filter, rs.filter_s, rs.filter_s), depth)
            add("rows", rs.n)
        rs.reset()
        return False


def rows() -> _Span:
    """The span of one burst of rows (a stripe's, or a whole matrix's)
    with the writer's parts of it."""
    return _Rows("rows")


@contextlib.contextmanager
def collect():
    """Yields a _Sums of the spans, counters and device seconds that close
    while it is open."""
    sums = _Sums()
    _open.append(sums)
    try:
        yield sums
    finally:
        _open.remove(sums)


@contextlib.contextmanager
def call(mode: str):
    """The record of one CLI call, yielded open and kept in history() once
    closed; rc is the CLI's exit code, 0, or 255 when the call raised."""
    label = _label("call:" + mode)
    row_sums.reset()
    rec = {"mode": mode, "t0": time.perf_counter(), "t1": None, "rc": None}
    with collect() as sums:
        try:
            yield rec
            rec["rc"] = 0
        except BaseException:
            rec["rc"] = -1 & 0xFF
            raise
        finally:
            rec["t1"] = t1 = time.perf_counter()
            if label is not None:
                label.__exit__(None, None, None)
            wall = t1 - rec["t0"]
            rec.update(
                wall_s=wall, unattributed_s=wall - sums.covered_s,
                spans={k: dict(zip(FIELDS, v)) for k, v in sums.spans.items()},
                counters=sums.counters, device=sums.device)
            _history.append(rec)


def history() -> list:
    """The last HISTORY closed call records, oldest first."""
    return list(_history)


class Events:
    """Device seconds of named spans of CUDA work, summed per name, from
    CUDA events; records nothing on other devices."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.pairs: list = []
        self.totals: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.cuda:
            yield
            return
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.pairs.append((name, start, end))

    def seconds(self) -> dict:
        """{name: seconds} of every span so far; waits for the recorded
        work to finish.  Each span's seconds are added to the open record
        and sums (as device.<name less _s>) by the first call that sees
        it, so reading again adds nothing twice."""
        for name, start, end in self.pairs:
            end.synchronize()
            s = start.elapsed_time(end) / 1e3
            self.totals[name] = self.totals.get(name, 0.0) + s
            key = "device." + name.removesuffix("_s")
            for sums in _open:
                sums.device[key] = sums.device.get(key, 0.0) + s
        self.pairs.clear()
        return dict(self.totals)
