"""Cost constants of the port's tier choices (counterpart of
kmerdb_tpu/ops/costcal.py, reduced to its defaults and overrides).

The interim rule of ops/intersect.py, ops/fused.py and cli/parts.py reads
the host scatter rates and the device tier's fixed cost from here.  Each
constant resolves as KMERDB_COST_* environment override > built-in
default.  No calibration cache is read: kmerdb_tpu's holds a TPU rig's
numbers, and the card's own calibration is not written yet.
"""

import os

#: built-in defaults: kmerdb_tpu's conservative constants
DEFAULTS = {
    "push_Bps": 1.0e9,
    "pull_Bps": 1.0e7,
    "dev_flops": 1.5e13,
    "host_rate": 2.0e10,
    "host_rate_big": 3.0e9,
    "fixed_s": 8.0,
    "fill_Bps": 2.0e9,
}

_ENV = {
    "push_Bps": "KMERDB_COST_PUSH_BPS",
    "pull_Bps": "KMERDB_COST_PULL_BPS",
    "dev_flops": "KMERDB_COST_DEV_FLOPS",
    "host_rate": "KMERDB_COST_HOST_RATE",
    "host_rate_big": "KMERDB_COST_HOST_RATE_BIG",
    "fixed_s": "KMERDB_COST_DEV_FIXED_S",
    "fill_Bps": "KMERDB_COST_FILL_BPS",
}


def resolve() -> dict:
    """Effective cost constants: environment override > default."""
    out = dict(DEFAULTS)
    for k, env in _ENV.items():
        v = os.environ.get(env)
        if v is not None:
            out[k] = float(v)
    return out
