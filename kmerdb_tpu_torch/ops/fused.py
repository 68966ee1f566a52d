"""Device grid tiers of all2all-parts: every cell of the grid over partial
databases as a weight-1 packed cross Gram (ops/gram.cross_u32_pk).

Counterpart of grid_group_counts, grid_rows_streamed and device_worthwhile
in kmerdb_tpu/ops/fused.py.  C_ij[r, c] = |K_r ∩ K_c| for sample r of part
i and sample c of part j is a sum over k-mers g of [r holds g][c holds g]:
with one incidence row per k-mer (the samples of the k-mer's pattern),
every cell is U_i^T V_j at weight 1, the diagonal cells included, so one
kernel computes the whole grid.

* grid_group_counts holds every part in host RAM and expresses each
  part's incidence over the union of all parts' k-mers, so each part is
  filled and pushed once per run; a (chunk, cell) product is skipped when
  either part owns no k-mer of the chunk.
* grid_rows_streamed holds one row part at a time, over its own k-mers:
  its chunks are pushed once per grid row and stay on the card within
  KMERDB_A2A_RESIDENT_MB (else they are re-pushed for every cell); each
  column part's chunk is pushed per cell, and a chunk that shares no k-mer
  with the column part is skipped.

Both pull each cell once, narrowed to uint16 by ops/gram.cast_rows when
every count fits.  The TPU rig's warm-up thread and AOT memo have no
counterpart: the CUDA kernels are built once per checkout.
"""

import os
import time

import numpy as np

from ..utils import native
from . import costcal
from .geom import KT, TILE
from .intersect import _card, _csr, _fill_bits, _round_up

#: phase timings and plan of the last grid_group_counts call, or of the
#: grid_rows_streamed generator so far
last_stats: dict = {}


def device_worthwhile(S: int, total_elems: int) -> bool:
    """Whether the grid's host work reaches the device tier's fixed cost
    (costcal's ``fixed_s``): kmerdb_tpu's host estimate (fused.py
    device_worthwhile: total sample k-mers times a mean group length of
    S/4, at the host scatter rate) under the port's interim rule, without
    kmerdb_tpu's TPU device constants.  The caller checks for a card."""
    c = costcal.resolve()
    rate = c["host_rate"] if S <= 1024 else c["host_rate_big"]
    return float(total_elems) * (S / 4) / rate >= c["fixed_s"]


def _chunk_rows(S_pad_max: int) -> int:
    """Incidence rows of one chunk: KMERDB_A2A_GROUP_MB (default 256) of
    packed rows at the widest part, whole K blocks."""
    group_bytes = int(os.environ.get("KMERDB_A2A_GROUP_MB", "256")) << 20
    return max(KT, (group_bytes * 8 // S_pad_max) // KT * KT)


class _Grid:
    """What both grid tiers share: the weight-1 vector, pushes, the cross
    Gram and the narrowed pull, with their device seconds."""

    def __init__(self, dev, narrow: bool):
        import torch
        from . import device_a2a, gram
        self.torch, self.gram = torch, gram
        self.dev, self.narrow = dev, narrow
        self.events = device_a2a._Events(dev)
        self.w = {}
        self.push_s = self.fill_s = 0.0

    def zeros(self, rows: int, cols: int):
        return self.torch.zeros((rows, cols), dtype=self.torch.int32,
                                device=self.dev)

    def push(self, buf: np.ndarray):
        """A copy of the packed scratch `buf` on the device."""
        t = time.perf_counter()
        out = self.torch.from_numpy(buf).to(self.dev, copy=True)
        self.push_s += time.perf_counter() - t
        return out

    def cross(self, U, V, C) -> None:
        rows = U.shape[0] * 8
        if rows not in self.w:
            self.w[rows] = self.torch.from_numpy(self.gram.pk_weight_order(
                np.ones(rows, dtype=np.uint32), KT).view(np.int32)) \
                .to(self.dev)
        with self.events.span("cross_s"):
            self.gram.cross_u32_pk(U, V, self.w[rows], C, n_limbs=1, kt=KT)

    def pull(self, C, S_i: int, S_j: int) -> np.ndarray:
        with self.events.span("pull_s"):
            host = (self.gram.cast_rows(C) if self.narrow else C) \
                .cpu().numpy()
        host = host.view(np.uint16 if self.narrow else np.uint32)
        return host[:S_i, :S_j].astype(np.uint32)

    def stats(self) -> dict:
        return {"fill_s": self.fill_s, "push_s": self.push_s,
                **self.events.seconds()}


def _fill_rows(rows, pids, offs, sids, buf) -> None:
    """Bit r & 7 of buf[r >> 3, s] for each sample s of pattern pids[e],
    r = rows[e] (native.fill_incidence_bits_rows, or its numpy form)."""
    if native.available:
        native.fill_incidence_bits_rows(rows, pids, offs, sids, buf)
        return
    for r, p in zip(rows, pids):
        buf[r >> 3, sids[offs[p]:offs[p + 1]]] |= np.uint8(1 << (r & 7))


def grid_group_counts(dbs) -> dict:
    """Every cell of the all2all-parts grid in one device pass:
    {(i, j): uint32[S_i, S_j]} for all i >= j; diagonal cells are the full
    symmetric all2all matrix of part i, the others db2db(dbs[i], dbs[j])."""
    dev = _card()
    t0 = time.perf_counter()
    P_n = len(dbs)
    union = np.unique(np.concatenate(
        [db.kmers for db in dbs if db.kmers.size]
        or [np.empty(0, dtype=np.uint64)]))
    G = int(union.size)
    S_pads = [_round_up(max(db.n_samples, 1), TILE) for db in dbs]
    CH = min(_chunk_rows(max(S_pads)), _round_up(max(G, 1), KT))
    max_count = max((int(db.sample_kmer_counts.max())
                     for db in dbs if db.sample_kmer_counts.size), default=0)
    grid = _Grid(dev, narrow=max_count < (1 << 16))

    # each part's k-mers as rows of the union, with their patterns' CSR
    part_rows = [np.searchsorted(union, db.kmers).astype(np.int64)
                 for db in dbs]
    part_pids = [np.ascontiguousarray(db.kmer_pattern_ids, dtype=np.int64)
                 for db in dbs]
    part_csr = [_csr(db) for db in dbs]
    C = {(i, j): grid.zeros(S_pads[i], S_pads[j])
         for i in range(P_n) for j in range(i + 1)}
    bufs = [np.zeros((CH // 8, sp), dtype=np.uint8) for sp in S_pads]
    skipped = 0
    for r0 in range(0, max(G, 1), CH):
        r1 = min(G, r0 + CH)
        U = [None] * P_n
        for pi in range(P_n):
            a, b = np.searchsorted(part_rows[pi], [r0, r1])
            if b <= a:
                continue          # the part owns no k-mer of this chunk
            t = time.perf_counter()
            bufs[pi][:] = 0
            _fill_rows(part_rows[pi][a:b] - r0, part_pids[pi][a:b],
                       *part_csr[pi], bufs[pi])
            grid.fill_s += time.perf_counter() - t
            U[pi] = grid.push(bufs[pi])
        for i in range(P_n):
            for j in range(i + 1):
                if U[i] is None or U[j] is None:
                    skipped += 1
                    continue
                grid.cross(U[i], U[j], C[i, j])

    out = {(i, j): grid.pull(Cij, dbs[i].n_samples, dbs[j].n_samples)
           for (i, j), Cij in C.items()}
    last_stats.clear()
    last_stats.update({
        "parts": P_n, "union_kmers": G, "chunk_rows": CH,
        "skipped_products": skipped, "narrow": grid.narrow,
        "device": str(dev), "total_s": time.perf_counter() - t0,
        **grid.stats()})
    return out


def grid_rows_streamed(get_part, part_sizes, max_count=None):
    """The grid one row part at a time, for parts that do not all fit the
    host cache: yields (i_row, {i_col: uint32[S_row, S_col]}) for each
    grid row, i_col from 0 to i_row.  get_part(i) loads part i (the
    caller's byte-budgeted cache); the cells are pulled as uint16 when
    max_count, the largest sample k-mer count, is below 2^16.

    C_ij[r, c] counts the k-mers of the row part shared with the column
    part and held by both r and c: a weight-1 cross Gram over the row
    part's own k-mer coordinates (k-mers absent from the row part add
    nothing to its cells)."""
    dev = _card()
    t0 = time.perf_counter()
    P_n = len(part_sizes)
    S_pads = [_round_up(max(s, 1), TILE) for s in part_sizes]
    CH_budget = _chunk_rows(max(S_pads, default=TILE))
    grid = _Grid(dev, narrow=max_count is not None and max_count < (1 << 16))
    resident_budget = int(os.environ.get("KMERDB_A2A_RESIDENT_MB",
                                         "4096")) << 20
    last_stats.clear()
    skipped = 0

    for i_row in range(P_n):
        db_row = get_part(i_row)
        G = int(db_row.kmers.size)
        sp_i = S_pads[i_row]
        CH = min(CH_budget, _round_up(max(G, 1), KT))
        n_chunks = max(1, -(-G // CH))
        row_pids = np.ascontiguousarray(db_row.kmer_pattern_ids,
                                        dtype=np.int64)
        row_csr = _csr(db_row)
        rbuf = np.zeros((CH // 8, sp_i), dtype=np.uint8)

        def row_chunk(c):
            t = time.perf_counter()
            rbuf[:] = 0
            _fill_bits(row_pids[c * CH:min(G, (c + 1) * CH)], *row_csr, rbuf)
            grid.fill_s += time.perf_counter() - t
            return grid.push(rbuf)

        resident = n_chunks * (CH // 8) * sp_i <= resident_budget
        U_chunks = [row_chunk(c) for c in range(n_chunks)] if resident \
            else None

        def row_operand(c):
            return U_chunks[c] if resident else row_chunk(c)

        cells = {}
        C_ii = grid.zeros(sp_i, sp_i)
        for c in range(n_chunks):
            U = row_operand(c)
            grid.cross(U, U, C_ii)
        cells[i_row] = grid.pull(C_ii, part_sizes[i_row], part_sizes[i_row])
        del C_ii

        for i_col in range(i_row):
            db_col = get_part(i_col)
            col_csr = _csr(db_col)
            # the row part's k-mers that the column part holds, and their
            # patterns there
            idx = np.minimum(np.searchsorted(db_col.kmers, db_row.kmers),
                             max(db_col.kmers.size - 1, 0))
            shared = (db_col.kmers.size > 0) & \
                (db_col.kmers[idx] == db_row.kmers)
            col_pids = db_col.kmer_pattern_ids[idx].astype(np.int64)
            cbuf = np.zeros((CH // 8, S_pads[i_col]), dtype=np.uint8)
            C_ij = grid.zeros(sp_i, S_pads[i_col])
            for c in range(n_chunks):
                a, b = c * CH, min(G, (c + 1) * CH)
                loc = np.flatnonzero(shared[a:b]).astype(np.int64)
                if loc.size == 0:
                    skipped += 1
                    continue      # no k-mer of the chunk in the column part
                t = time.perf_counter()
                cbuf[:] = 0
                _fill_rows(loc, col_pids[a + loc], *col_csr, cbuf)
                grid.fill_s += time.perf_counter() - t
                grid.cross(row_operand(c), grid.push(cbuf), C_ij)
            cells[i_col] = grid.pull(C_ij, part_sizes[i_row],
                                     part_sizes[i_col])
            del C_ij
        last_stats.update({
            "parts": P_n, "rows_done": i_row + 1, "chunk_rows": CH,
            "resident_rows": resident, "skipped_products": skipped,
            "narrow": grid.narrow, "device": str(dev),
            "total_s": time.perf_counter() - t0, **grid.stats()})
        yield i_row, cells
