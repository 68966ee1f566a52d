"""kmer-db's all2all CSV lines, written from the reference's counts.

header:  'kmer-length: <k> fraction: <f> ,db-samples ,<name>,...,'
totals:  'query-samples,total-kmers,<count>,...,'
dense:   '<name>,<count>,<c_0>,...,<c_{i-1}>,'   (row i: the lower triangle)
sparse:  '<name>,<count>,<j+1>:<c_j>,...,'       (non-zero cells that pass
                                                 the count bounds)
Every line ends with a newline.  The fraction is C++'s default output of a
double (six significant digits, as Python's 'g').
"""

from __future__ import annotations

MAX_COUNT = 0xFFFFFFFF


class Output:
    """What an all2all argument list asks of the CSV: dense, or sparse with
    inclusive count bounds ('-min num-kmers:<n>', '-max num-kmers:<n>').
    Other criteria are refused: the reference does not compute them."""

    def __init__(self, args):
        self.sparse = False
        self.lo, self.hi = 0, MAX_COUNT
        it = iter(args)
        for a in it:
            if a == "-sparse":
                self.sparse = True
            elif a in ("-min", "-max"):
                crit, _, val = next(it).rpartition(":")
                if crit not in ("", "num-kmers"):
                    raise ValueError(f"criterion {crit!r} not in the "
                                     "reference")
                if a == "-min":
                    self.lo = int(val)
                else:
                    self.hi = int(val)
            else:
                raise ValueError(f"all2all option {a!r} not in the "
                                 "reference")

    def row(self, name: str, total: int, cells) -> str:
        """Row of a sample over its lower-triangle counts `cells`."""
        if not self.sparse:
            return f"{name},{total}," + "".join(f"{int(c)}," for c in cells) \
                + "\n"
        kept = "".join(f"{j + 1}:{int(c)}," for j, c in enumerate(cells)
                       if c != 0 and self.lo <= c <= self.hi)
        return f"{name},{total}," + kept + "\n"


def header(k: int, fraction: float, names) -> str:
    return (f"kmer-length: {k} fraction: {fraction:g} ,db-samples ,"
            + "".join(n + "," for n in names) + "\n")


def totals(counts) -> str:
    return "query-samples,total-kmers," + "".join(f"{int(c)}," for c in counts) \
        + "\n"
