"""Tier choice and device tiers of the counting kernels: all2all, the
batched query contraction of new2all, and db2db.

Counterpart of kmerdb_tpu/ops/intersect.py.  Each kernel has a host C++
tier and a CUDA device tier, and a knob that forces one (=1 the device,
=0 the host): KMERDB_A2A_DEVICE for all2all, KMERDB_N2A_DEVICE for
new2all, KMERDB_D2D_DEVICE for db2db.  Unset, the device tier runs when
the host tier's predicted time reaches the device tier's fixed cost
(costcal's ``fixed_s``) and a CUDA card is present: an interim rule until
the cost model is measured on the card.  Each prediction is kmerdb_tpu's
host estimate: sum(len^2) over patterns for all2all, the exact apply
workload read off the probes for new2all, sum(|rows| * |cols|) over the
pattern pairs for db2db.  KMERDB_A2A_PALLAS means nothing here.

The host stages (query probes and apply, the pattern-pair intersection,
chunk plans) are kmerdb_tpu's, imported through host.py.  A failure on the
device propagates: nothing is recomputed on the host behind the caller's
back.  torch is imported only where a device tier runs.
"""

import os
import time

import numpy as np

from ..host import KmerPatternDb, costcal, native
from ..host import intersect as host_intersect
from .geom import KT, LIMB_BITS, TILE

#: the new2all device tier's seconds, chunks and bytes, summed over its
#: calls until the caller clears the dict (the CLI calls it once per
#: flush), and the padded shapes and limbs of the last call
n2a_stats: dict = {}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _forced(var: str):
    """True or False when the knob `var` is 1 or 0; None when unset."""
    env = os.environ.get(var, "")
    return env == "1" if env in ("0", "1") else None


def _cuda_available() -> bool:
    import torch      # only here: a host-tier run never pays its import
    return torch.cuda.is_available()


def _card():
    """The CUDA card: _torchinit.device(), which raises without one."""
    from .. import _torchinit
    return _torchinit.device()


def host_cost_s(db: KmerPatternDb) -> float:
    """Predicted seconds of the host C++ scatter: the model of
    kmerdb_tpu/ops/device_a2a.host_cost_s, restated so that the port
    imports none of kmerdb_tpu's device modules."""
    lens = np.diff(db.pattern_offsets)
    c = costcal.resolve()
    rate = c["host_rate"] if db.n_samples <= 1024 else c["host_rate_big"]
    return float(np.dot(lens, lens)) / rate


def _want_device(db: KmerPatternDb) -> bool:
    forced = _forced("KMERDB_A2A_DEVICE")
    if forced is not None:
        return forced
    return host_cost_s(db) >= costcal.resolve()["fixed_s"] \
        and _cuda_available()


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


# ---------------------------------------------------------------------------
# new2all: sims = H @ B
# ---------------------------------------------------------------------------

def _m2a_host_s(db: KmerPatternDb, hits) -> float:
    """Predicted seconds of the host apply from the probes' hit patterns
    (kmerdb_tpu's many2all_counts estimate): the pattern-major apply that
    runs from 512 samples on caps each hit at the S/8 units of a row AXPY."""
    lens = np.diff(db.pattern_offsets)
    if db.n_samples >= 512:
        cap = np.uint32(max(db.n_samples // 8, 1))
        ops = float(sum(np.minimum(lens[hp], cap).sum() for hp, _ in hits))
    else:
        ops = float(sum(lens[hp].sum() for hp, _ in hits))
    return ops / costcal.resolve()["host_rate"]


def _m2a_host(db: KmerPatternDb, queries, probes) -> np.ndarray:
    """The host tier of many2all_counts (kmerdb_tpu's): the batched probe
    and CSR apply, reusing probes the tier choice already paid for."""
    S = db.n_samples
    if probes is not None:
        return host_intersect._m2a_host_apply(db, probes[0], S)
    if native.available and db.n_patterns:
        return host_intersect._m2a_host_apply(
            db, host_intersect._probe_queries(db, queries)[0], S)
    return np.stack([host_intersect.one2all_counts(db, q) for q in queries])


def many2all_counts(db: KmerPatternDb, queries: list,
                    use_device: bool | None = None) -> np.ndarray:
    """uint32[Q, S]: common-k-mer counts of each query (sorted unique k-mer
    array) against every database sample: the batched one2all of new2all.

    Both tiers probe the queries on the host first (hit pattern ids and
    counts per query).  The host tier applies the counts through the
    pattern CSR; the device tier builds H (hits per query and pattern) and
    B (pattern incidence) per pattern chunk and accumulates sims = H @ B
    on the card (m2a_prepare, _m2a_device).  use_device overrides the tier
    choice of the module doc."""
    Q, S = len(queries), db.n_samples
    if Q == 0 or S == 0:
        return np.zeros((Q, S), dtype=np.uint32)
    probes, probe_s = None, 0.0
    if use_device is None:
        use_device = _forced("KMERDB_N2A_DEVICE")
    if use_device is None:
        use_device = False
        if db.n_patterns and native.available:
            # the probes first: the host estimate reads the exact apply
            # workload off them, and both tiers reuse them
            t = time.perf_counter()
            probes = host_intersect._probe_queries(db, queries)
            probe_s = time.perf_counter() - t
            use_device = _m2a_host_s(db, probes[0]) \
                >= costcal.resolve()["fixed_s"] and _cuda_available()
    if not use_device or db.n_patterns == 0:
        return _m2a_host(db, queries, probes)

    dev = _card()
    t0 = time.perf_counter()
    if probes is None:
        probes = host_intersect._probe_queries(db, queries)
    t1 = time.perf_counter()
    H_all, B_all, n_limbs = m2a_prepare(db, queries, probes=probes)
    t2 = time.perf_counter()
    C = _m2a_device(H_all, B_all, n_limbs, dev)[:Q, :S]
    _add_stats(n2a_stats, calls=1, queries=Q, chunks=H_all.shape[0],
               h_bytes=H_all.nbytes, b_bytes=B_all.nbytes,
               probe_s=probe_s + t1 - t0, prepare_s=t2 - t1,
               total_s=probe_s + time.perf_counter() - t0)
    n2a_stats.update(Q_pad=H_all.shape[1], P_pad=H_all.shape[2],
                     S_pad=B_all.shape[2], n_limbs=n_limbs)
    return C


def m2a_prepare(db: KmerPatternDb, queries: list, probes=None):
    """Host operands of sims = H @ B (kmerdb_tpu's m2a_prepare, at the
    port's padding): (H_all [n_chunks, Q_pad, P_pad] hit counts, uint8
    when one 8-bit limb holds every count and uint32 otherwise; B_all
    int8 0/1 [n_chunks, P_pad, S_pad] pattern incidence; n_limbs).

    Q and S are padded to TILE, each chunk's patterns to KT (a multiple of
    the kernel's 128-pattern stage); chunks follow kmerdb_tpu's pattern
    and CSR-element budgets.  probes forwards _probe_queries output when
    the caller already ran it."""
    hi = host_intersect
    Q, S, P = len(queries), db.n_samples, db.n_patterns
    if probes is None:
        probes = hi._probe_queries(db, queries)
    probes, max_c = probes
    n_limbs = max(1, (max_c.bit_length() + 7) // 8)

    offs = db.pattern_offsets
    sids = db.pattern_sample_ids
    el_pid = db.element_pattern_ids()
    Q_pad = _round_up(Q, TILE)
    S_pad = _round_up(S, TILE)
    chunk = min(hi._CHUNK, max(KT, (64 << 20) // max(S_pad, Q_pad)))
    bounds = hi._chunk_plan(offs, P, chunk, hi._CHUNK_E)
    n_chunks = len(bounds) - 1
    P_pad = _round_up(max(bounds[c + 1] - bounds[c]
                          for c in range(n_chunks)), KT)

    # single-limb hit counts fit uint8, a quarter of the push
    h_dtype = np.uint8 if n_limbs == 1 else np.uint32
    B_all = _zeros((n_chunks, P_pad, S_pad), np.int8)
    H_all = _zeros((n_chunks, Q_pad, P_pad), h_dtype)
    for c in range(n_chunks):
        p0, p1 = bounds[c], bounds[c + 1]
        lo, hi_e = int(offs[p0]), int(offs[p1])
        rows = (el_pid[lo:hi_e] - p0).astype(np.int32)
        cols = np.ascontiguousarray(sids[lo:hi_e], dtype=np.int32)
        if native.available:
            native.fill_incidence(rows, cols, B_all[c])
        else:
            B_all[c][rows, cols] = 1
        for qi, (hp, hc) in enumerate(probes):
            j0, j1 = np.searchsorted(hp, [p0, p1])
            H_all[c, qi, hp[j0:j1] - p0] = hc[j0:j1]
    return H_all, B_all, n_limbs


def _zeros(shape, dtype) -> np.ndarray:
    """A zeroed host array; from the C++ runtime's lazily provisioned
    anonymous memory when it is present (only written pages cost)."""
    if not native.available:
        return np.zeros(shape, dtype)
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return native.alloc_array(n, np.uint8, populate=False).view(dtype) \
        .reshape(shape)


def _m2a_device(H_all: np.ndarray, B_all: np.ndarray, n_limbs: int,
                dev) -> np.ndarray:
    """uint32[Q_pad, S_pad] = sum over chunks of H_all[c] @ B_all[c],
    accumulated on `dev` by ops/gram.matmul_u32_acc (kmerdb_tpu's
    _m2a_device_mosaic): C stays on the device, each chunk pushes its H
    and B, and C is pulled once."""
    import torch
    from . import device_a2a, gram
    _, Q_pad, _ = H_all.shape
    S_pad = B_all.shape[2]
    h_view = np.uint8 if H_all.dtype == np.uint8 else np.int32
    C = torch.zeros((Q_pad, S_pad), dtype=torch.int32, device=dev)
    events = device_a2a._Events(dev)
    push_s = 0.0
    for c in range(H_all.shape[0]):
        t = time.perf_counter()
        H = torch.from_numpy(H_all[c].view(h_view)).to(dev)
        B = torch.from_numpy(B_all[c]).to(dev)
        push_s += time.perf_counter() - t
        with events.span("matmul_s"):
            gram.matmul_u32_acc(H, B, C, n_limbs=n_limbs)
    t = time.perf_counter()
    out = C.cpu().numpy().view(np.uint32)
    _add_stats(n2a_stats, push_s=push_s, pull_s=time.perf_counter() - t,
               **events.seconds())
    return out


def _add_stats(stats: dict, **kw) -> None:
    for k, v in kw.items():
        stats[k] = stats.get(k, 0) + v


# ---------------------------------------------------------------------------
# db2db: C = U^T diag(counts) V over matched pattern pairs
# ---------------------------------------------------------------------------

def db2db_counts(db_row: KmerPatternDb,
                 db_col: KmerPatternDb) -> np.ndarray:
    """uint32[S_row, S_col] cross-database common-k-mer counts.

    The host intersects the two sorted k-mer arrays into matched pattern
    pairs (p1, p2) with their shared k-mer counts (kmerdb_tpu's
    d2d_pairs); the host tier then scatters each count over the pair's
    |rows| x |cols| cells, the device tier contracts the pairs on the card
    (_d2d_device)."""
    S1, S2 = db_row.n_samples, db_col.n_samples
    pairs = host_intersect.d2d_pairs(db_row, db_col)
    if pairs is None:
        return np.zeros((S1, S2), dtype=np.uint32)
    up1, up2, cnts = pairs
    want_device = _forced("KMERDB_D2D_DEVICE")
    if want_device is None:
        want_device = False
        if native.available:
            l1 = np.diff(db_row.pattern_offsets)[up1].astype(np.float64)
            l2 = np.diff(db_col.pattern_offsets)[up2].astype(np.float64)
            c = costcal.resolve()
            rate = c["host_rate"] if max(S1, S2) <= 1024 \
                else c["host_rate_big"]
            want_device = float(l1 @ l2) / rate >= c["fixed_s"] \
                and _cuda_available()
    if want_device:
        return _d2d_device(db_row, db_col, up1, up2, cnts)
    return _d2d_host(db_row, db_col, up1, up2, cnts)


def _csr(db: KmerPatternDb) -> tuple:
    return (np.ascontiguousarray(db.pattern_offsets, dtype=np.int64),
            np.ascontiguousarray(db.pattern_sample_ids, dtype=np.uint32))


def _d2d_host(db_row, db_col, up1, up2, cnts) -> np.ndarray:
    """The host tier of db2db (kmerdb_tpu's): one scatter per pair."""
    (o1, s1), (o2, s2) = _csr(db_row), _csr(db_col)
    C = np.zeros((db_row.n_samples, db_col.n_samples), dtype=np.uint32)
    if native.available:
        native.cross_apply(up1, up2, cnts, o1, s1, o2, s2, C)
        return C
    for a, b, cnt in zip(up1, up2, cnts):
        C[np.ix_(s1[o1[a]:o1[a + 1]], s2[o2[b]:o2[b + 1]])] += np.uint32(cnt)
    return C


def _d2d_device(db_row, db_col, up1, up2, cnts) -> np.ndarray:
    """The device tier of db2db (kmerdb_tpu's _d2d_device): pattern-pair
    chunks, bit-packed along the pair axis straight from both CSRs, are
    contracted into C on the card by ops/gram.cross_u32_pk with the pairs'
    shared counts as weights (7-bit limbs up to the largest count); C is
    pulled once.  The weights are permuted for the port's own KT."""
    import torch
    from . import gram
    dev = _card()
    S1, S2 = db_row.n_samples, db_col.n_samples
    S1_pad, S2_pad = _round_up(max(S1, 1), TILE), _round_up(max(S2, 1), TILE)
    n_pairs = up1.size
    rows = min(_round_up(max(n_pairs, 1), KT), 8 * host_intersect._CHUNK)
    n_limbs = max(1, -(-int(cnts.max()).bit_length() // LIMB_BITS))
    (o1, s1), (o2, s2) = _csr(db_row), _csr(db_col)

    Ubuf = np.zeros((rows // 8, S1_pad), dtype=np.uint8)
    Vbuf = np.zeros((rows // 8, S2_pad), dtype=np.uint8)
    wbuf = np.zeros(rows, dtype=np.uint32)
    C = torch.zeros((S1_pad, S2_pad), dtype=torch.int32, device=dev)
    for g0 in range(0, n_pairs, rows):
        g1 = min(n_pairs, g0 + rows)
        Ubuf[:] = 0
        Vbuf[:] = 0
        wbuf[:] = 0
        for buf, pids, offs, sids in ((Ubuf, up1[g0:g1], o1, s1),
                                      (Vbuf, up2[g0:g1], o2, s2)):
            _fill_bits(np.ascontiguousarray(pids), offs, sids, buf)
        wbuf[:g1 - g0] = cnts[g0:g1]
        # copies: the scratch is refilled for the next chunk
        gram.cross_u32_pk(
            torch.from_numpy(Ubuf).to(dev, copy=True),
            torch.from_numpy(Vbuf).to(dev, copy=True),
            torch.from_numpy(gram.pk_weight_order(wbuf, KT).view(np.int32))
            .to(dev, copy=True), C, n_limbs=n_limbs, kt=KT)
    return np.ascontiguousarray(C.cpu().numpy().view(np.uint32)[:S1, :S2])


def _fill_bits(pids, offs, sids, buf) -> None:
    """Bit i & 7 of buf[i >> 3, s] for each sample s of pattern pids[i]
    (native.fill_incidence_bits, or its numpy form)."""
    if native.available:
        native.fill_incidence_bits(pids, offs, sids, buf)
        return
    for i, p in enumerate(pids):
        buf[i >> 3, sids[offs[p]:offs[p + 1]]] |= np.uint8(1 << (i & 7))
