"""Distance metrics and min/max cell filters.

Metric registry matches reference src/params.cpp:15-41; filters match
src/sparse_filters.h.  Metrics are evaluated in float64 with the same
integer-argument semantics (num_kmers_t is uint32; cnt1+cnt2-common is
computed in uint32 with wraparound, then converted to double).

math.log (glibc libm) is used rather than np.log on the output path:
the reference binary links glibc's log(), and 6-decimal parity can hinge
on the last ulp.  Vectorized variants using np.log exist for on-device /
bulk computation where parity is not required.
"""

import math

import numpy as np

_U32 = np.uint64(0xFFFFFFFF)


def _u32(x):
    return int(x) & 0xFFFFFFFF


def _u32sum(*xs):
    """uint32-wraparound combination computed in Python ints (numpy
    scalar inputs would emit overflow warnings)."""
    t = 0
    for x in xs:
        t += int(x)
    return t & 0xFFFFFFFF


def _div(a: float, b: float) -> float:
    """C++ double-division semantics: x/0 = inf, 0/0 = nan (the
    reference never guards denominators; zero-k-mer samples produce
    inf/nan cells and the run continues)."""
    if b != 0:
        return a / b
    return math.inf if a > 0 else (-math.inf if a < 0 else math.nan)


def _log(x: float) -> float:
    """C++ log() semantics: log(nan) = nan, log(<0) = nan (Python's
    math.log raises instead)."""
    try:
        return math.log(x)
    except ValueError:
        return math.nan


def jaccard(common, cnt1, cnt2, k):
    return _div(float(common), _u32sum(cnt1, cnt2, -int(common)))


def metric_min(common, cnt1, cnt2, k):
    return _div(float(common), min(_u32(cnt1), _u32(cnt2)))


def metric_max(common, cnt1, cnt2, k):
    return _div(float(common), max(_u32(cnt1), _u32(cnt2)))


def cosine(common, cnt1, cnt2, k):
    # reference: common / sqrt(cnt1 * cnt2); cnt1*cnt2 in uint32 wraps!
    # (num_kmers_t * num_kmers_t is uint32 arithmetic in C++)
    return _div(float(common), math.sqrt((_u32(cnt1) * _u32(cnt2)) & 0xFFFFFFFF))


def mash(common, query_cnt, db_cnt, k):
    d_j = _div(float(common), _u32sum(query_cnt, db_cnt, -int(common)))
    if d_j == 0:
        return 1.0
    return (-1.0 / k) * _log((2 * d_j) / (d_j + 1))


def ani(common, query_cnt, db_cnt, k):
    return 1.0 - mash(common, query_cnt, db_cnt, k)


def ani_shorter(common, query_cnt, db_cnt, k):
    d_j = _div(float(common), min(_u32(query_cnt), _u32(db_cnt)))
    d_m = 1.0 if d_j == 0 else (-1.0 / k) * _log((2 * d_j) / (d_j + 1))
    return 1.0 - d_m


def mash_query(common, query_cnt, db_cnt, k):
    d_j = _div(float(common), _u32(query_cnt))
    if d_j == 0:
        return 1.0
    return (-1.0 / k) * _log((2 * d_j) / (d_j + 1))


def num_kmers(common, query_cnt, db_cnt, k):
    return float(common)


AVAILABLE_METRICS = {
    "jaccard": jaccard,
    "min": metric_min,
    "max": metric_max,
    "cosine": cosine,
    "mash": mash,
    "ani": ani,
    "ani-shorter": ani_shorter,
    "mash-query": mash_query,
    "num-kmers": num_kmers,
}

# ---------------------------------------------------------------------------
# vectorized metric evaluation (bulk filtering of large rows); same
# uint32-wraparound semantics, inf/nan on zero denominators
# ---------------------------------------------------------------------------

def _vf(c, denom):
    return c.astype(np.float64) / denom.astype(np.float64)


def _v_jaccard(c, c1, c2, k):
    return _vf(c, c1 + c2 - c)


def _v_min(c, c1, c2, k):
    return _vf(c, np.minimum(c1, c2))


def _v_max(c, c1, c2, k):
    return _vf(c, np.maximum(c1, c2))


def _v_cosine(c, c1, c2, k):
    return c.astype(np.float64) / np.sqrt((c1 * c2).astype(np.float64))


def _v_mash_from_j(d_j, k):
    m = (-1.0 / k) * np.log((2 * d_j) / (d_j + 1))
    return np.where(d_j == 0, 1.0, m)


def _v_mash(c, c1, c2, k):
    return _v_mash_from_j(_v_jaccard(c, c1, c2, k), k)


def _v_ani(c, c1, c2, k):
    return 1.0 - _v_mash(c, c1, c2, k)


def _v_ani_shorter(c, c1, c2, k):
    return 1.0 - _v_mash_from_j(_v_min(c, c1, c2, k), k)


def _v_mash_query(c, c1, c2, k):
    return _v_mash_from_j(_vf(c, np.broadcast_to(c1, c.shape)), k)


def _v_num_kmers(c, c1, c2, k):
    return c.astype(np.float64)


_VECTOR_METRICS = {
    "jaccard": _v_jaccard,
    "min": _v_min,
    "max": _v_max,
    "cosine": _v_cosine,
    "mash": _v_mash,
    "ani": _v_ani,
    "ani-shorter": _v_ani_shorter,
    "mash-query": _v_mash_query,
    "num-kmers": _v_num_kmers,
}


class MetricFilter:
    """Bounds on a metric value (sparse_filters.h:12-23)."""

    def __init__(self):
        self.bounds = [-math.inf, math.inf]
        self.metric = None

    def __call__(self, common, cnt1, cnt2, kmer_length):
        v = self.metric(common, cnt1, cnt2, kmer_length)
        return self.bounds[0] <= v <= self.bounds[1]


class KmerFilter:
    """Bounds on the raw common-k-mer count (sparse_filters.h:26-30)."""

    def __init__(self):
        self.bounds = [0, 0xFFFFFFFF]

    def __call__(self, n):
        return self.bounds[0] <= n <= self.bounds[1]

    @property
    def is_trivial(self):
        return self.bounds[0] <= 0 and self.bounds[1] >= 0xFFFFFFFF


class CombinedFilter:
    """AND of all metric filters + the kmer filter (sparse_filters.h:33-61)."""

    def __init__(self, metric_filters, kmer_filter, row_counts, col_counts, kmer_length):
        self.metric_filters = metric_filters
        self.kmer_filter = kmer_filter
        self.row_counts = row_counts
        self.col_counts = col_counts
        self.kmer_length = kmer_length

    def __call__(self, common, row_id, col_id):
        for f in self.metric_filters.values():
            if not f(common, self.row_counts[row_id], self.col_counts[col_id],
                     self.kmer_length):
                return False
        return self.kmer_filter(common)

    def mask_row(self, values: np.ndarray, row_id: int,
                 col_ids: np.ndarray | None = None) -> np.ndarray:
        """Boolean keep-mask for a row of counts.

        Trivial filters short-circuit; small rows use the exact scalar
        metric path (glibc log, matching the output formatter ulp for
        ulp); large rows vectorize with numpy (np.log may differ from
        glibc log in the last ulp — only observable if a metric value
        lands exactly on a user bound)."""
        values = np.asarray(values)
        if self.is_trivial:
            return np.ones(values.size, dtype=bool)
        if col_ids is None:
            col_ids = np.arange(values.size)
        if values.size <= 2048:
            keep = np.ones(values.size, dtype=bool)
            for i in range(values.size):
                if not self(int(values[i]), row_id, int(col_ids[i])):
                    keep[i] = False
            return keep

        c = values.astype(np.uint32)
        c1 = np.uint32(self.row_counts[row_id])
        c2 = np.asarray(self.col_counts, dtype=np.uint32)[col_ids]
        keep = np.ones(values.size, dtype=bool)
        suspect = np.zeros(values.size, dtype=bool)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            for name, f in self.metric_filters.items():
                v = _VECTOR_METRICS[name](c, c1, c2, self.kmer_length)
                keep &= (v >= f.bounds[0]) & (v <= f.bounds[1])
                # numpy's SIMD transcendentals can differ from the
                # scalar glibc path by 1 ulp; values landing on a user
                # bound get re-decided through the exact scalar path
                for b in f.bounds:
                    if np.isfinite(b):
                        tol = 4 * np.finfo(np.float64).eps \
                            * np.maximum(np.abs(v), abs(b))
                        suspect |= np.abs(v - b) <= tol
        keep &= (values >= self.kmer_filter.bounds[0]) \
            & (values <= self.kmer_filter.bounds[1])
        for i in np.flatnonzero(suspect):
            keep[i] = self(int(values[i]), row_id, int(col_ids[i]))
        return keep

    @property
    def is_trivial(self):
        return not self.metric_filters and self.kmer_filter.is_trivial
