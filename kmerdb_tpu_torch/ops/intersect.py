"""Tier choice, host stages and device tiers of the counting kernels:
all2all, the batched query contraction of new2all, one2all and db2db.

Counterpart of kmerdb_tpu/ops/intersect.py.  Each kernel has a host C++
tier and a CUDA device tier, and a knob that forces one (=1 the device,
=0 the host): KMERDB_A2A_DEVICE for all2all, KMERDB_N2A_DEVICE for
new2all, KMERDB_D2D_DEVICE for db2db.  Unset, the device tier runs when
the host tier's predicted time reaches the device tier's fixed cost
(costcal's ``fixed_s``) and a CUDA card is present: an interim rule until
the cost model is measured on the card.  Each prediction is kmerdb_tpu's
host estimate: sum(len^2) over patterns for all2all, the exact apply
workload read off the probes for new2all, sum(|rows| * |cols|) over the
pattern pairs for db2db.

The device tiers of all2all and new2all come in two forms, as in
kmerdb_tpu: KMERDB_A2A_PALLAS unset or 1 takes the packed tiers
(ops/device_a2a.all2all_device; _m2a_device on matmul_u32_acc), which
kmerdb_tpu runs on its chip; KMERDB_A2A_PALLAS=0 takes the scan tier
(_a2a_scan on gram_u32_tri, _m2a_scan on matmul_u32), which fills each
pattern chunk's unpacked int8 incidence on the host, pushes it and adds
the chunk's product into C on the card.  Every tier gives the same counts.

The host stages (query probes and apply, one2all, the pattern-pair
intersection, chunk plans) are this package's copies of kmerdb_tpu's.  A
failure on the device propagates: nothing is recomputed on the host or on
another tier behind the caller's back.  torch is imported only where a
device tier runs.
"""

import os
import time

import numpy as np

from ..models.database import KmerPatternDb
from ..utils import native
from . import costcal
from .geom import KT, LIMB_BITS, TILE

#: patterns per chunk of the chunked tiers (kmerdb_tpu's pattern budget)
_CHUNK = 32768
#: CSR elements per chunk
_CHUNK_E = 1 << 20

#: the new2all device tier's seconds, chunks and bytes, summed over its
#: calls until the caller clears the dict (the CLI calls it once per
#: flush), and the padded shapes and limbs of the last call
n2a_stats: dict = {}
#: the scan tier's chunks and seconds (host clock; kernels by CUDA
#: events), summed over its calls until the caller clears the dict, and
#: the process's peak device memory at the end of the last call
scan_stats: dict = {}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _chunk_plan(offs: np.ndarray, P: int, max_p: int, max_e: int,
                p0: int = 0):
    """Chunk bounds over the patterns [p0, P), limited by pattern and
    element budgets."""
    bounds = [p0]
    while bounds[-1] < P:
        p0 = bounds[-1]
        p1 = min(P, p0 + max_p)
        hi = int(np.searchsorted(offs, offs[p0] + max_e, side="right")) - 1
        p1 = max(p0 + 1, min(p1, hi))
        bounds.append(p1)
    return bounds


def _run_length_counts(sorted_arr: np.ndarray):
    """(unique_values int64[], counts uint32[]) of a sorted array."""
    if sorted_arr.size == 0:
        return (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint32))
    boundary = np.empty(sorted_arr.size, dtype=bool)
    boundary[0] = True
    np.not_equal(sorted_arr[1:], sorted_arr[:-1], out=boundary[1:])
    starts = np.flatnonzero(boundary)
    uniq = sorted_arr[starts].astype(np.int64)
    counts = np.diff(np.append(starts, sorted_arr.size)).astype(np.uint32)
    return uniq, counts


def _scan_tier() -> bool:
    """KMERDB_A2A_PALLAS=0: the device tiers take the unpacked scan."""
    return os.environ.get("KMERDB_A2A_PALLAS") == "0"


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
    kmerdb_tpu/ops/device_a2a.host_cost_s."""
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
        if _scan_tier():
            return _a2a_scan(db)
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
        return _m2a_host_apply(db, probes[0], S)
    if native.available and db.n_patterns:
        return _m2a_host_apply(db, _probe_queries(db, queries)[0], S)
    return np.stack([one2all_counts(db, q) for q in queries])


def many2all_counts(db: KmerPatternDb, queries: list,
                    use_device: bool | None = None) -> np.ndarray:
    """uint32[Q, S]: common-k-mer counts of each query (sorted unique k-mer
    array) against every database sample: the batched one2all of new2all.

    Both tiers probe the queries on the host first (hit pattern ids and
    counts per query).  The host tier applies the counts through the
    pattern CSR; the device tier builds H (hits per query and pattern) and
    B (pattern incidence) per pattern chunk and accumulates sims = H @ B
    on the card (m2a_prepare, then _m2a_device, or _m2a_scan under
    KMERDB_A2A_PALLAS=0).  use_device overrides the tier choice of the
    module doc."""
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
            probes = _probe_queries(db, queries)
            probe_s = time.perf_counter() - t
            use_device = _m2a_host_s(db, probes[0]) \
                >= costcal.resolve()["fixed_s"] and _cuda_available()
    if not use_device or db.n_patterns == 0:
        return _m2a_host(db, queries, probes)

    dev = _card()
    t0 = time.perf_counter()
    if probes is None:
        probes = _probe_queries(db, queries)
    t1 = time.perf_counter()
    H_all, B_all, n_limbs = m2a_prepare(db, queries, probes=probes)
    t2 = time.perf_counter()
    run = _m2a_scan if _scan_tier() else _m2a_device
    C = run(H_all, B_all, n_limbs, dev)[:Q, :S]
    _add_stats(n2a_stats, calls=1, queries=Q, chunks=H_all.shape[0],
               h_bytes=H_all.nbytes, b_bytes=B_all.nbytes,
               probe_s=probe_s + t1 - t0, prepare_s=t2 - t1,
               total_s=probe_s + time.perf_counter() - t0)
    n2a_stats.update(Q_pad=H_all.shape[1], P_pad=H_all.shape[2],
                     S_pad=B_all.shape[2], n_limbs=n_limbs)
    return C


def m2a_prepare(db: KmerPatternDb, queries: list, q_align: int | None = None,
                probes=None):
    """Host operands of sims = H @ B (kmerdb_tpu's m2a_prepare, at the
    port's padding): (H_all [n_chunks, Q_pad, P_pad] hit counts, uint8
    when one 8-bit limb holds every count and uint32 otherwise; B_all
    int8 0/1 [n_chunks, P_pad, S_pad] pattern incidence; n_limbs).

    Q and S are padded to TILE, each chunk's patterns to KT (a multiple of
    the kernel's 128-pattern stage); chunks follow kmerdb_tpu's pattern
    and CSR-element budgets.  q_align replaces Q's padding multiple (a mesh
    cuts the query axis into one share a slot); probes forwards
    _probe_queries output when the caller already ran it."""
    Q, S, P = len(queries), db.n_samples, db.n_patterns
    if probes is None:
        probes = _probe_queries(db, queries)
    probes, max_c = probes
    n_limbs = max(1, (max_c.bit_length() + 7) // 8)

    offs = db.pattern_offsets
    el_pid = db.element_pattern_ids()
    Q_pad = _round_up(Q, q_align or TILE)
    S_pad = _round_up(S, TILE)
    chunk = min(_CHUNK, max(KT, (64 << 20) // max(S_pad, Q_pad)))
    bounds = _chunk_plan(offs, P, chunk, _CHUNK_E)
    n_chunks = len(bounds) - 1
    P_pad = _round_up(max(bounds[c + 1] - bounds[c]
                          for c in range(n_chunks)), KT)

    # single-limb hit counts fit uint8, a quarter of the push
    h_dtype = np.uint8 if n_limbs == 1 else np.uint32
    B_all = _zeros((n_chunks, P_pad, S_pad), np.int8)
    H_all = _zeros((n_chunks, Q_pad, P_pad), h_dtype)
    for c in range(n_chunks):
        p0, p1 = bounds[c], bounds[c + 1]
        _fill_incidence(*_chunk_cells(db, el_pid, p0, p1), B_all[c])
        for qi, (hp, hc) in enumerate(probes):
            j0, j1 = np.searchsorted(hp, [p0, p1])
            H_all[c, qi, hp[j0:j1] - p0] = hc[j0:j1]
    return H_all, B_all, n_limbs


def _chunk_cells(db: KmerPatternDb, el_pid, p0: int, p1: int) -> tuple:
    """(rows, cols) int32 of the incidence cells of patterns [p0, p1):
    row i is pattern p0 + i, col the sample."""
    lo, hi = int(db.pattern_offsets[p0]), int(db.pattern_offsets[p1])
    return ((el_pid[lo:hi] - p0).astype(np.int32),
            np.ascontiguousarray(db.pattern_sample_ids[lo:hi], dtype=np.int32))


def _fill_incidence(rows, cols, B) -> None:
    """B[rows, cols] = 1 (native.fill_incidence, or its numpy form)."""
    if native.available:
        native.fill_incidence(rows, cols, B)
    else:
        B[rows, cols] = 1


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
# the scan tier (KMERDB_A2A_PALLAS=0): unpacked chunks, one product each
# ---------------------------------------------------------------------------

def _scan_chunks(db: KmerPatternDb, p0: int = 0, p1: int | None = None
                 ) -> tuple:
    """(chunk bounds, P_pad, S_pad) of all2all's scan tier over the patterns
    [p0, p1) (default: all), planned as kmerdb_tpu's all2all_counts plans
    its scan: at most ~192 MB of int8 incidence a chunk, then kmerdb_tpu's
    pattern and CSR-element budgets; each chunk's patterns padded to the
    port's KT."""
    S_pad = _round_up(db.n_samples, TILE)
    chunk = min(_CHUNK, max(1024, (192 << 20) // S_pad))
    bounds = _chunk_plan(db.pattern_offsets,
                         db.n_patterns if p1 is None else p1, chunk,
                         _CHUNK_E, p0)
    return bounds, _round_up(int(np.diff(bounds).max(initial=1)), KT), S_pad


def _a2a_scan(db: KmerPatternDb, *, triangle: bool = True) -> np.ndarray:
    """Full symmetric uint32[S, S] on the card by the scan tier
    (kmerdb_tpu's _a2a_scan): _a2a_scan_partial over every pattern, the
    triangle mirrored on the card, C pulled once."""
    dev = _card()
    t0 = time.perf_counter()
    stats: dict = {}
    C = _a2a_scan_partial(db, 0, db.n_patterns, dev, stats,
                          triangle=triangle)
    return _scan_finish(db, C, triangle, t0, stats)


def _a2a_scan_partial(db: KmerPatternDb, p0: int, p1: int, dev, stats: dict,
                      *, triangle: bool = True):
    """int32[S_pad, S_pad] on `dev`: the Gram of the patterns [p0, p1) by
    the scan tier.  Each chunk's int8 incidence is filled into one reused
    host buffer and pushed, and its Gram, ops/gram.gram_u32_tri (gram_u32
    when not `triangle`), is added into C on the device; the triangle is
    left unmirrored.  The weights are limbed to the database's largest, so
    every range takes the same kernel.  Work is queued on the current
    stream and not waited for; chunks, host seconds and the kernels' event
    spans ("events") are added into `stats`."""
    import torch
    from . import device_a2a, gram
    bounds, P_pad, S_pad = _scan_chunks(db, p0, p1)
    w = db.pattern_num_kmers
    n_limbs = max(1, (int(w.max()).bit_length() + 7) // 8)
    el_pid = db.element_pattern_ids()
    B = _zeros((P_pad, S_pad), np.int8)
    wbuf = np.zeros(P_pad, np.uint32)
    kernel = gram.gram_u32_tri if triangle else gram.gram_u32
    C = torch.zeros((S_pad, S_pad), dtype=torch.int32, device=dev)
    events = stats.setdefault("events", device_a2a._Events(dev))
    fill_s = push_s = 0.0
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        ta = time.perf_counter()
        rows, cols = _chunk_cells(db, el_pid, c0, c1)
        _fill_incidence(rows, cols, B)
        wbuf[:] = 0
        wbuf[:c1 - c0] = w[c0:c1]
        tb = time.perf_counter()
        # copies: the buffers are refilled for the next chunk
        Bc = torch.from_numpy(B).to(dev, copy=True)
        wc = torch.from_numpy(wbuf.view(np.int32)).to(dev, copy=True)
        tc = time.perf_counter()
        B[rows, cols] = 0
        fill_s += tb - ta + time.perf_counter() - tc
        push_s += tc - tb
        with events.span("gram_s"):
            C.add_(kernel(Bc, wc, n_limbs=n_limbs))
    _add_stats(stats, chunks=len(bounds) - 1, fill_s=fill_s, push_s=push_s)
    return C


def _scan_finish(db: KmerPatternDb, C, triangle: bool, t0: float,
                 stats: dict) -> np.ndarray:
    """uint32[S, S] from C on its device: mirror the triangle there and
    pull C once; adds the call, with `stats`, to scan_stats."""
    import torch
    S = db.n_samples
    events = stats.pop("events")
    if triangle:
        with events.span("mirror_s"):
            C = torch.tril(C) + torch.tril(C, -1).T
    kernel_s = events.seconds()          # waits for the device
    t = time.perf_counter()
    out = np.ascontiguousarray(C.cpu().numpy().view(np.uint32)[:S, :S])
    _scan_record(C.device, t0, pull_s=time.perf_counter() - t, **kernel_s,
                 **stats)
    return out


def _m2a_scan(H_all: np.ndarray, B_all: np.ndarray, n_limbs: int,
              dev) -> np.ndarray:
    """uint32[Q_pad, S_pad] = sum over chunks of H_all[c] @ B_all[c] on
    `dev` by the scan tier (kmerdb_tpu's _m2a_scan): each chunk's H and B
    are pushed and their product, ops/gram.matmul_u32, is added into C on
    the card; C is pulled once."""
    import torch
    from . import device_a2a, gram
    t0 = time.perf_counter()
    h_view = np.uint8 if H_all.dtype == np.uint8 else np.int32
    C = torch.zeros((H_all.shape[1], B_all.shape[2]), dtype=torch.int32,
                    device=dev)
    events = device_a2a._Events(dev)
    push_s = 0.0
    for c in range(H_all.shape[0]):
        t = time.perf_counter()
        H = torch.from_numpy(H_all[c].view(h_view)).to(dev)
        B = torch.from_numpy(B_all[c]).to(dev)
        push_s += time.perf_counter() - t
        with events.span("matmul_s"):
            C.add_(gram.matmul_u32(H, B, n_limbs=n_limbs))
    kernel_s = events.seconds()          # waits for the card
    t = time.perf_counter()
    out = C.cpu().numpy().view(np.uint32)
    _scan_record(dev, t0, chunks=H_all.shape[0], push_s=push_s,
                 pull_s=time.perf_counter() - t, **kernel_s)
    return out


def _scan_record(dev, t0: float, **kw) -> None:
    """Add one scan call to scan_stats, with the peak device memory."""
    import torch
    _add_stats(scan_stats, calls=1, total_s=time.perf_counter() - t0, **kw)
    if dev.type == "cuda":
        scan_stats["peak_mib"] = torch.cuda.max_memory_allocated(dev) >> 20


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
    pairs = d2d_pairs(db_row, db_col)
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
    """The device tier of db2db (kmerdb_tpu's _d2d_device):
    _d2d_partial over every pair on the card, C pulled once."""
    C = _d2d_partial(db_row, db_col, up1, up2, cnts, _card())
    return np.ascontiguousarray(C.cpu().numpy().view(np.uint32)
                                [:db_row.n_samples, :db_col.n_samples])


def _d2d_chunk_rows(n_pairs: int) -> int:
    """Pairs a chunk of _d2d_partial holds: all of them, padded to KT, up
    to 8 * _CHUNK; each chunk is one cross_u32_pk launch."""
    return min(_round_up(max(n_pairs, 1), KT), 8 * _CHUNK)


def _d2d_partial(db_row, db_col, up1, up2, cnts, dev):
    """int32[S1_pad, S2_pad] on `dev`: the pattern pairs (up1, up2) with
    their shared counts `cnts` contracted by ops/gram.cross_u32_pk.  Chunks
    of pairs, bit-packed along the pair axis straight from both CSRs, are
    pushed and added into C with the counts as weights, in 7-bit limbs up
    to the largest count; the weights are permuted for the port's own KT.
    No pairs give zeros.  Work is queued on the current stream and not
    waited for."""
    import torch
    from . import gram
    S1, S2 = db_row.n_samples, db_col.n_samples
    S1_pad, S2_pad = _round_up(max(S1, 1), TILE), _round_up(max(S2, 1), TILE)
    n_pairs = up1.size
    rows = _d2d_chunk_rows(n_pairs)
    n_limbs = max(1, -(-int(cnts.max(initial=0)).bit_length() // LIMB_BITS))
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
    return C


def _fill_bits(pids, offs, sids, buf) -> None:
    """Bit i & 7 of buf[i >> 3, s] for each sample s of pattern pids[i]
    (native.fill_incidence_bits, or its numpy form)."""
    if native.available:
        native.fill_incidence_bits(pids, offs, sids, buf)
        return
    for i, p in enumerate(pids):
        buf[i >> 3, sids[offs[p]:offs[p + 1]]] |= np.uint8(1 << (i & 7))


# ---------------------------------------------------------------------------
# host stages: probes, one2all, the CSR apply, pattern-pair intersection
# ---------------------------------------------------------------------------

def one2all_counts(db: KmerPatternDb, query_kmers: np.ndarray) -> np.ndarray:
    """uint32[S] common-kmer counts of one query (sorted unique k-mers)
    against every database sample (reference one2all,
    similarity_calculator.cpp:661-925)."""
    S = db.n_samples
    sims = np.zeros(S, dtype=np.uint32)
    if query_kmers.size == 0 or db.n_kmers == 0:
        return sims
    offs = np.ascontiguousarray(db.pattern_offsets, dtype=np.int64)
    if native.available:
        pids = native.one2all_probe(
            np.ascontiguousarray(query_kmers),
            np.ascontiguousarray(db.kmers),
            np.ascontiguousarray(db.kmer_pattern_ids, dtype=np.int32))
        if pids.size == 0:
            return sims
        # run-length count of sorted hit pids (avoids a bincount
        # zeroing n_patterns counters per query)
        nz, counts = _run_length_counts(np.sort(pids))
        native.csr_apply(np.ascontiguousarray(nz), counts, offs,
                         np.ascontiguousarray(db.pattern_sample_ids,
                                              dtype=np.uint32),
                         sims)
        return sims
    idx = np.searchsorted(db.kmers, query_kmers)
    idx[idx >= db.n_kmers] = db.n_kmers - 1
    found = db.kmers[idx] == query_kmers
    pids = db.kmer_pattern_ids[idx[found]]
    pat_counts = np.bincount(pids, minlength=db.n_patterns)
    nz = np.flatnonzero(pat_counts)
    for p in nz:
        cnt = np.uint32(pat_counts[p])
        seg = db.pattern_sample_ids[offs[p]:offs[p + 1]]
        sims[seg] += cnt
    return sims


class _ProbeList(list):
    """Per-query (hit_pids, counts) pairs, plus the flat batched-probe
    arrays (`flat`) that let the host apply run as ONE threaded native
    call instead of a Python loop."""
    flat = None


def _probe_queries(db: KmerPatternDb, queries: list):
    """Probe every query against the database k-mer array:
    ([(hit_pids, counts)], max_count) -- the shared host stage of both
    many2all tiers (the tier choice reads the exact apply workload from it
    before committing to a tier).

    Native path: ONE bucketed multi-query intersect (the db array streams
    from RAM once for the whole batch, key ranges fan out across threads --
    the role of the reference's per-query pool threads,
    console_new2all.cpp:64-95)."""
    kmers = np.ascontiguousarray(db.kmers)
    pids32 = np.ascontiguousarray(db.kmer_pattern_ids, dtype=np.int32)
    probes = _ProbeList()
    if native.available and len(queries) > 1:
        hp, hc, qoffs, ucnt, max_c = native.many2all_probe(
            queries, kmers, pids32, db.n_patterns)
        for q in range(len(queries)):
            o = int(qoffs[q])
            u = int(ucnt[q])
            probes.append((hp[o:o + u], hc[o:o + u]))
        probes.flat = (hp, hc, qoffs, ucnt)
        return probes, max_c
    max_c = 1
    for q in queries:
        hit = np.sort(native.one2all_probe(
            np.ascontiguousarray(q), kmers, pids32)) \
            if native.available else _probe_fallback(db, q)
        hp, cnts = _run_length_counts(hit)
        probes.append((hp, cnts))
        if cnts.size:
            max_c = max(max_c, int(cnts.max()))
    return probes, max_c


def _probe_fallback(db: KmerPatternDb, q: np.ndarray) -> np.ndarray:
    idx = np.searchsorted(db.kmers, q)
    idx[idx >= db.n_kmers] = db.n_kmers - 1
    found = db.kmers[idx] == q
    return np.sort(db.kmer_pattern_ids[idx[found]])


def _m2a_host_apply(db: KmerPatternDb, probes, S: int) -> np.ndarray:
    """Host CSR apply of pre-computed probe results (the one2all_counts
    tail, reusing probes the tier choice already paid for)."""
    offs = np.ascontiguousarray(db.pattern_offsets, dtype=np.int64)
    sids = np.ascontiguousarray(db.pattern_sample_ids, dtype=np.uint32)
    flat = getattr(probes, "flat", None)
    if flat is not None and native.available:
        out = native.alloc_array(len(probes) * S, np.uint32).reshape(
            len(probes), S)
        hp, hc, qoffs, ucnt = flat
        # pattern-major for wide sample axes: each hit pattern's sample
        # list is read once for the whole batch and dense patterns apply
        # as SIMD row AXPYs; at small S the AXPY never engages and the hit
        # transpose is pure overhead, so query-major keeps the narrow
        # shapes.  KMERDB_APPLY=qmajor/pmajor forces.
        mode = os.environ.get("KMERDB_APPLY", "")
        if mode == "qmajor" or (S < 512 and mode != "pmajor"):
            native.csr_apply_many(qoffs, ucnt, hp, hc, offs, sids, out)
        else:
            native.csr_apply_patmajor(qoffs, ucnt, hp, hc, offs, sids,
                                      db.n_patterns, out)
        return out
    out = np.zeros((len(probes), S), dtype=np.uint32)
    for i, (hp, cnts) in enumerate(probes):
        if hp.size:
            native.csr_apply(np.ascontiguousarray(hp, dtype=np.int64),
                             np.ascontiguousarray(cnts, dtype=np.uint32),
                             offs, sids, out[i])
    return out


def d2d_pairs(db_row: KmerPatternDb, db_col: KmerPatternDb):
    """Intersect the two sorted k-mer arrays and run-length-count the
    matched (pid1, pid2) pattern pairs: returns (up1, up2, counts) or
    None when the databases share no k-mers."""
    if db_row.n_kmers == 0 or db_col.n_kmers == 0:
        return None
    if native.available:
        p1, p2 = native.intersect_probe(
            np.ascontiguousarray(db_row.kmers),
            np.ascontiguousarray(db_row.kmer_pattern_ids, dtype=np.int32),
            np.ascontiguousarray(db_col.kmers),
            np.ascontiguousarray(db_col.kmer_pattern_ids, dtype=np.int32))
    else:
        idx = np.searchsorted(db_col.kmers, db_row.kmers)
        idx[idx >= db_col.n_kmers] = db_col.n_kmers - 1
        found = db_col.kmers[idx] == db_row.kmers
        p1 = db_row.kmer_pattern_ids[found]
        p2 = db_col.kmer_pattern_ids[idx[found]]
    if p1.size == 0:
        return None
    pair = p1.astype(np.int64) * db_col.n_patterns + p2.astype(np.int64)
    pair.sort(kind="stable")
    upair, cnts = _run_length_counts(pair)
    up1 = (upair // db_col.n_patterns).astype(np.int64)
    up2 = (upair % db_col.n_patterns).astype(np.int64)
    return up1, up2, np.ascontiguousarray(cnts, dtype=np.uint32)
