"""The comparison that decides `correct`: the CSV lines of the program's
calls against the reference's, and the numbers it reads, each with its
limit.  Counts are integers, so every comparison is exact: limit 0."""

from __future__ import annotations

LIMITS = {
    "calls_failed": 0,          # calls whose exit code is not 0
    "calls_unlike_first": 0,    # calls whose CSV differs from the first's
    "line_count_off": 0,        # calls with another number of lines
    "lines_wrong": 0,           # sampled lines unequal to the reference's
    "cells_wrong": 0,           # cells of those lines that differ
}


def cells_differing(expected: str, got: str) -> int:
    """Fields of two CSV lines that differ: the leading fields by position,
    sparse 'col:count' cells by column (a missing cell counts 0), dense
    cells by position."""
    e, g = expected.rstrip("\n").split(","), got.rstrip("\n").split(",")
    if any(":" in t for t in e[2:] + g[2:]):
        head = sum(a != b for a, b in zip(e[:2], g[:2]))
        em = dict(t.split(":", 1) for t in e[2:] if ":" in t)
        gm = dict(t.split(":", 1) for t in g[2:] if ":" in t)
        body = sum(em.get(c, "0") != gm.get(c, "0") for c in em.keys() | gm)
        return head + body
    return sum(a != b for a, b in zip(e, g)) + abs(len(e) - len(g))


def judge(expected: dict, n_lines: int, calls: list) -> dict:
    """The numbers compared.  expected: {line number: line} of the
    reference; calls: one dict a call, with "rc" and, where the sink
    reported, "report" (crc32, bytes, lines, kept lines)."""
    out = dict.fromkeys(LIMITS, 0)
    first = None
    for call in calls:
        if call["rc"] != 0 or call.get("report") is None:
            out["calls_failed"] += 1
            continue
        rep = call["report"]
        digest = (rep["crc32"], rep["bytes"])
        if first is None:
            first = digest
        elif digest != first:
            out["calls_unlike_first"] += 1
        if rep["lines"] != n_lines or rep.get("unterminated"):
            out["line_count_off"] += 1
        for no, line in expected.items():
            got = rep["kept"].get(str(no))
            if got is None:
                out["lines_wrong"] += 1
                out["cells_wrong"] += line.count(",")
                continue
            got += "\n"
            if got != line:
                out["lines_wrong"] += 1
                out["cells_wrong"] += cells_differing(line, got)
    return out


def correct(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


def lines(numbers: dict) -> list:
    """'name value limit' lines for standard error."""
    return [f"check {k} {numbers[k]} limit {LIMITS[k]}" for k in LIMITS]


def record(numbers: dict) -> dict:
    return {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
