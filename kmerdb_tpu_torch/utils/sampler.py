"""Per-row reservoir sampling for -sample-rows (reference src/sampler.h).

Two strategies:
* "best": bounded heap keeping the highest-scoring items; ties broken
  by smaller item id (sampler.h:45-65).  Deterministic.
* "random": uniform reservoir replacement driven by one std::mt19937_64
  per row, default-seeded (sampler.h:67-78).  Reproduced here with a
  bit-exact MT19937-64 so outputs match the reference.
"""

import heapq


class MT19937_64:
    """std::mt19937_64 (default seed 5489), bit-exact."""

    N, M = 312, 156
    MATRIX_A = 0xB5026F5AA96619E9
    UPPER = 0xFFFFFFFF80000000
    LOWER = 0x7FFFFFFF
    MASK = (1 << 64) - 1

    def __init__(self, seed: int = 5489):
        mt = [0] * self.N
        mt[0] = seed & self.MASK
        for i in range(1, self.N):
            mt[i] = (6364136223846793005 * (mt[i - 1] ^ (mt[i - 1] >> 62)) + i) \
                & self.MASK
        self.mt = mt
        self.mti = self.N

    def __call__(self) -> int:
        if self.mti >= self.N:
            mt = self.mt
            for i in range(self.N):
                x = (mt[i] & self.UPPER) | (mt[(i + 1) % self.N] & self.LOWER)
                xa = x >> 1
                if x & 1:
                    xa ^= self.MATRIX_A
                mt[i] = mt[(i + self.M) % self.N] ^ xa
            self.mti = 0
        x = self.mt[self.mti]
        self.mti += 1
        x ^= (x >> 29) & 0x5555555555555555
        x ^= (x << 17) & 0x71D67FFFEDA60000
        x ^= (x << 37) & 0xFFF7EEE000000000
        x ^= x >> 43
        return x


class Sampler:
    def __init__(self, n_rows: int, max_items: int, strategy: str):
        self.max_items = max_items
        self.strategy = strategy
        self.rows: list[list] = [[] for _ in range(n_rows)]
        if strategy == "random":
            self.sizes = [0] * n_rows
            self.mts = [MT19937_64() for _ in range(n_rows)]

    def add(self, row: int, item: int, value: int, score: float):
        data = self.rows[row]
        data.append((item, value, score))
        if self.strategy == "random":
            self.sizes[row] += 1
        if len(data) <= self.max_items:
            return
        if self.strategy == "best":
            self._select_best(data)
        else:
            self._select_random(row, data)

    # heap ordering: "max-heap" whose front is the WORST item —
    # lowest score, ties by larger item id (sampler.h heap_comparer)
    @staticmethod
    def _hkey(entry):
        item, value, score = entry
        return (score, -item)

    def _select_best(self, data):
        # reference keeps a bounded min-heap once full (sampler.h:52-65);
        # the front is the worst kept item (lowest score, ties by larger
        # item), evicted when the newcomer beats it.  O(log N) per
        # offered cell.  Rows are converted in place to heap layout
        # [(key, item, value), ...] on first overflow.
        item, value, score = data.pop()
        if not isinstance(data[0][0], tuple):
            data[:] = [((s, -i), i, v) for i, v, s in data]
            heapq.heapify(data)
        new = ((score, -item), item, value)
        if new[0] >= data[0][0]:
            heapq.heapreplace(data, new)

    def _select_random(self, row, data):
        mt = self.mts[row]
        if mt() % self.sizes[row] == 0:
            pass  # drop the newcomer
        else:
            idx = mt() % self.max_items
            data[idx] = data[-1]
        data.pop()

    def _row_items(self, row: int):
        """(item, value) pairs regardless of plain/heap row layout."""
        data = self.rows[row]
        if data and isinstance(data[0][0], tuple):
            return [(item, value) for _, item, value in data]
        return [(item, value) for item, value, _ in data]

    def row_pairs(self, row: int):
        """(item+1, value) sorted by item (saveRowSparse, sampler.h:123-138).
        Accepts an optional idx shift having been applied at add() time."""
        return [(item + 1, value)
                for item, value in sorted(self._row_items(row))]

    def row_pairs_shifted(self, row: int, idx_shift: int):
        return [(idx_shift + item + 1, value)
                for item, value in sorted(self._row_items(row))]

    def n_in_row(self, row: int) -> int:
        return len(self.rows[row])


def feed_lower_triangle(sampler, C, filt, criterion, counts, kmer_len,
                        shift=0):
    """Offer every passing strict-lower-triangle cell of C to the
    sampler, both as (i, j) and transposed (j, i) — add_to_sampler
    semantics (array.h:450-543).  `shift` rebases row/col ids for
    multi-part grids."""
    import numpy as np
    crit = criterion or (lambda c, a, b, k: 1.0)
    for r in range(C.shape[0]):
        row = C[r, :r]
        for j in np.flatnonzero(row):
            v = int(row[j])
            if filt(v, r, int(j)):
                score = float(crit(v, int(counts[r]), int(counts[j]),
                                   kmer_len))
                sampler.add(shift + r, shift + int(j), v, score)
                sampler.add(shift + int(j), shift + r, v, score)
