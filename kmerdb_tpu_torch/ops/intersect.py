"""Tier choice for all2all: the host C++ scatter or the CUDA device tier.

Counterpart of all2all_counts in kmerdb_tpu/ops/intersect.py.
KMERDB_A2A_DEVICE=1 forces the device tier and =0 the host tier.  Unset,
the device tier runs when a CUDA card is present and the host tier's
predicted time reaches the device tier's fixed cost (costcal's
``fixed_s``) — an interim rule until the cost model is measured on the
card.  A failure on the device propagates: nothing is recomputed on the
host behind the caller's back.
"""

import os

import numpy as np

from ..host import KmerPatternDb, costcal, native


def host_cost_s(db: KmerPatternDb) -> float:
    """Predicted seconds of the host C++ scatter: the model of
    kmerdb_tpu/ops/device_a2a.host_cost_s, restated so that the port
    imports none of kmerdb_tpu's device modules."""
    lens = np.diff(db.pattern_offsets)
    c = costcal.resolve()
    rate = c["host_rate"] if db.n_samples <= 1024 else c["host_rate_big"]
    return float(np.dot(lens, lens)) / rate


def _want_device(db: KmerPatternDb) -> bool:
    env = os.environ.get("KMERDB_A2A_DEVICE", "")
    if env in ("0", "1"):
        return env == "1"
    if host_cost_s(db) < costcal.resolve()["fixed_s"]:
        return False
    import torch      # only here: a host-tier run never pays its import
    return torch.cuda.is_available()


def all2all_counts(db: KmerPatternDb) -> np.ndarray:
    """Full symmetric common-k-mer count matrix, uint32[S, S]; the
    diagonal holds the samples' own k-mer counts."""
    S = db.n_samples
    if db.n_patterns == 0 or S == 0:
        return np.zeros((S, S), dtype=np.uint32)
    if _want_device(db):
        from . import device_a2a
        return device_a2a.all2all_device(db)
    if not native.available:
        raise RuntimeError("the host all2all tier needs the C++ host "
                           "runtime (g++); KMERDB_A2A_DEVICE=1 selects the "
                           "device tier")
    return native.a2a_dense(db.pattern_offsets, db.pattern_sample_ids,
                            db.pattern_num_kmers, S)
