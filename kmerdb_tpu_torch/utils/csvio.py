"""CSV assembly with reference byte parity.

Formats (verified against test/synth, test/virus goldens):

* header:  'kmer-length: <k> fraction: <f:%g> ,db-samples ,<n1>,<n2>,...,\\n'
  (console_all2all.cpp:40-42)
* totals:  'query-samples,total-kmers,<c1>,<c2>,...,\\n'
* dense row:   '<name>,<count>,<v>,<v>,...,\\n' (lower triangle for
  all2all: row i has i cells; full row for new2all)
* sparse row:  '<name>,<count>,<j+1>:<v>,...,\\n' — only non-zero cells
  (conversion.h:286-298); all2all emits only the strict lower triangle.
* one2all output has no trailing newline after its single data row
  (console_one2all.cpp:86-92).
"""

from .num2str import format_double_cpp, ints_row, ints_row_sparse


def matrix_header(kmer_length: int, fraction: float, names) -> str:
    return (f"kmer-length: {kmer_length} fraction: {format_double_cpp(fraction)}"
            " ,db-samples ," + "".join(n + "," for n in names) + "\n")


def totals_row(counts) -> str:
    return "query-samples,total-kmers," + ints_row(counts) + "\n"


def dense_row(name: str, count: int, values) -> str:
    return f"{name},{count}," + ints_row(values) + "\n"


def sparse_row(name: str, count: int, values) -> str:
    return f"{name},{count}," + ints_row_sparse(values) + "\n"


def sparse_row_pairs(name: str, count: int, pairs) -> str:
    """pairs: iterable of (one_based_col, value)."""
    return (f"{name},{count},"
            + "".join(f"{c}:{v}," for c, v in pairs) + "\n")


def sparse_row_pairs_arrays(name: str, count: int, cols, vals) -> str:
    """sparse_row_pairs from parallel arrays (cols one-based, already
    globally shifted) — the native formatter replaces the per-cell
    Python tuple loop in the all2all-parts row assembly."""
    from . import native
    if native.available:
        return (f"{name},{count},"
                + native.row_pairs(cols, vals).decode("ascii") + "\n")
    return sparse_row_pairs(name, count,
                            zip([int(c) for c in cols],
                                [int(v) for v in vals]))
