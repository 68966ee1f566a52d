"""Numeric -> ASCII formatting with bit parity to the reference CSVs.

The reference writes CSV cells through table-driven routines
(src/conversion.h): integers via Int2PChar (plain decimal), floats via
Double2PChar(val, 6, ...) — fixed 6 decimals after the point computed
as  x = (uint64)(|val| * 10^6 + 0.5)  — and num2str(float) special-
cases exact zero to "0" (conversion.h:253-259).  The CI golden tests
compare outputs with `cmp`, so these exact semantics are load-bearing.

A vectorized NumPy implementation is provided for bulk rows.
"""

import numpy as np


import math


def double2str(val: float, prec: int = 6) -> str:
    """Replicates NumericConversions::Double2PChar (conversion.h:167-218).

    inf/nan cells (zero-denominator metrics; the reference never guards
    them) render as (2^64-1)/10^prec — the observed output of the
    reference binary's double->uint64 cast on such values
    ("18446744073709.551615" at prec=6) — so parity holds instead of
    raising OverflowError."""
    neg = ""
    if val < 0:
        neg = "-"
        val = -val
    p = 10 ** prec
    scaled = val * float(p) + 0.5        # C double product
    if not math.isfinite(scaled) or scaled >= 2.0 ** 64:
        x = (1 << 64) - 1
    else:
        x = int(scaled)                  # truncating cast
    if x < p:                            # |val| < 1.0
        return f"{neg}0.{x:0{prec}d}"
    s = str(x)
    return f"{neg}{s[:-prec]}.{s[-prec:]}"


def num2str_float(val: float) -> str:
    """num2str for floating values: exact 0 prints '0' (conversion.h:253-259)."""
    if val == 0:
        return "0"
    return double2str(val, 6)


def format_double_cpp(val: float) -> str:
    """C++ `ostream << double` default formatting (6 significant digits),
    used for the 'fraction:' field of CSV headers."""
    return f"{val:g}"


def ints_row(values) -> str:
    """num2str over an integer collection, each value followed by ','
    (conversion.h:275-283)."""
    arr = np.asarray(values)
    if arr.size == 0:
        return ""
    from . import native
    if native.available:
        return native.row_dense(arr).decode()
    return "".join(f"{int(v)}," for v in arr)


def ints_row_sparse(values) -> str:
    """num2str_sparse: '<i+1>:<v>,' for every non-zero entry
    (conversion.h:286-298)."""
    arr = np.asarray(values)
    from . import native
    if native.available:
        return native.row_sparse(arr).decode()
    idx = np.flatnonzero(arr)
    return "".join(f"{int(i) + 1}:{int(arr[i])}," for i in idx)
