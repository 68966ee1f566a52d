"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit), and the work that the
common-k-mer Gram needs, counted from the database's sizes alone.

The Gram is C = B^T diag(w) B over P patterns (each a set of samples with
its k-mer count w) and S samples; all2all needs the T = S(S+1)/2 cells of
its lower triangle.  Whatever implements it, it multiplies and adds each
pattern into each cell once, and reads the incidence bits, the weights and
writes the triangle once:

    ops   = 2 P T
    bytes = P S / 8 + 4 P + 4 T

The bound is the larger of ops over the int8 tensor-core peak and bytes
over the memory bandwidth.  Padding, limbs and the mirror half that an
implementation may also compute are not work.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
POWER_W = 700.0


def gram_work(n_patterns: int, n_samples: int) -> tuple:
    """(ops, bytes) of the lower-triangle Gram."""
    P, S = int(n_patterns), int(n_samples)
    T = S * (S + 1) // 2
    return 2.0 * P * T, P * S / 8 + 4.0 * P + 4.0 * T


def gram_bound_s(n_patterns: int, n_samples: int) -> float:
    ops, nbytes = gram_work(n_patterns, n_samples)
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
