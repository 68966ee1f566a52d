"""The least time an H100 needs for the count filter of all2all's sparse
pull (filter_colsum on the streamed route), counted from the number of
samples alone.

all2all -sparse keeps the cells of the lower triangle whose counts lie
inside the bounds.  Whatever implements it, the filter reads each of the
S(S-1)/2 counts below the diagonal once, as int32, and writes one int32
count of survivors per tile row and column, ceil(S/128) x S of them, from
which the pull picks its 128 x 128 tiles:

    bytes = 4 S(S-1)/2 + 4 ceil(S/128) S
    bound = bytes / HBM_BYTES_PER_S

No arithmetic is counted: a compare and an add a count are far below the
card's rates.  Padding, the diagonal, the upper half and a stripe counted
again are not work.
"""

from __future__ import annotations

from .roofline import HBM_BYTES_PER_S

#: the tile edge of the survivor pull
PULL_TILE = 128


def filter_bytes(n_samples: int) -> int:
    S = int(n_samples)
    return 4 * (S * (S - 1) // 2) + 4 * (-(-S // PULL_TILE)) * S


def filter_bound_s(n_samples: int) -> float:
    return filter_bytes(n_samples) / HBM_BYTES_PER_S
