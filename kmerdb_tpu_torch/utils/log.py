"""Three-level logger mirroring the reference's Log singleton
(src/log.h:18-146): NORMAL always on, VERBOSE (-v), DEBUG (-vv).
Messages go to stderr so CSV-to-stdout pipelines stay clean."""

import sys

NORMAL, VERBOSE, DEBUG = 0, 1, 2

_level = NORMAL


def set_level(level: int) -> None:
    global _level
    _level = level


def verbose(*args) -> None:
    if _level >= VERBOSE:
        print(*args, file=sys.stderr)


def debug(*args) -> None:
    if _level >= DEBUG:
        print(*args, file=sys.stderr)


class Progress:
    """Percent-progress reporter for long streamed loops (the
    reference's refresh::progress_state role, libs/refresh/logs/lib/
    progress.h:1-124, printed at similarity_calculator.cpp:479,1347):
    renders 100*counter/total at an auto-scaled precision and emits
    '\\r<pct>%' ONLY when the rendered string changes — naturally
    rate-limited to at most 10^(2+precision) prints per run.  Gated at
    -v so default CSV pipelines keep a quiet stderr."""

    def __init__(self, total: int, precision: int | None = None):
        self.total = max(int(total), 1)
        if precision is None:
            precision = (0 if self.total <= 100 else
                         1 if self.total <= 10_000 else
                         2 if self.total <= 1_000_000 else 3)
        self.precision = min(precision, 6)
        self.counter = 0
        self._last = None
        self._printed = False

    def step(self, n: int = 1) -> None:
        self.counter += n
        if _level < VERBOSE:
            return
        msg = f"{100.0 * self.counter / self.total:.{self.precision}f}%"
        if msg != self._last:
            self._last = msg
            self._printed = True
            print("\r" + msg, end="", file=sys.stderr, flush=True)

    def done(self) -> None:
        if self._printed:
            print(file=sys.stderr)
            self._printed = False
