"""all2all-parts: the grid comparison over partial databases
(kmerdb_tpu/cli/parts.run_all2all_parts).

Pass 1 reads the sample tables of every part; pass 2 walks the grid rows
and writes globally indexed sparse rows.  The cells come from one of three
tiers:

* the device grid (ops/fused.grid_group_counts): every cell in one pass
  over union-coordinate incidence, every part held in host RAM;
* the streamed device grid (ops/fused.grid_rows_streamed): one row part
  at a time, when the parts' expanded size (4x their files) exceeds the
  cache budget KMERDB_PARTS_CACHE_MB (default 4096);
* per cell: the diagonal through ops/intersect.all2all_counts, the
  others through ops/intersect.db2db_counts, each with its own tier choice;
  under a device mesh (``-mesh``) through parallel/sharded.py's
  all2all_counts_sharded and db2db_counts_sharded.

KMERDB_GRID_DEVICE=1 forces a device grid and =0 the per-cell route;
unset, a device grid runs for more than one part when no mesh is active,
the grid's host work reaches costcal's ``fixed_s``
(ops/fused.device_worthwhile) and a CUDA card is present.
KMERDB_GRID_STREAM=1/0 forces the streamed grid on or off.  A device
failure propagates: no cell is recomputed per cell.
"""

import os

import numpy as np

from ..io import dbfile
from ..ops import fused, intersect
from ..parallel import runtime
from ..utils import csvio, filters, log
from ..utils import sampler as sampler_mod
from .params import UsageError


def _grid_tier(part_fns, part_sizes, sample_counts, cache_budget,
               mesh=None):
    """None (per cell), "grid" or "stream"; a mesh turns an unforced
    device grid off."""
    grid = intersect._forced("KMERDB_GRID_DEVICE")
    if grid is None:
        grid = mesh is None and len(part_fns) > 1 \
            and fused.device_worthwhile(int(sum(part_sizes)),
                                        int(sum(sample_counts))) \
            and intersect._cuda_available()
    if not grid:
        return None
    stream = intersect._forced("KMERDB_GRID_STREAM")
    if stream is None:
        # varint databases expand about 2-4x in RAM: stream the grid when
        # the expanded parts cannot all sit inside the cache budget
        stream = sum(os.path.getsize(fn) for fn in part_fns) * 4 \
            > cache_budget
    return "stream" if stream else "grid"


def run_all2all_parts(p):
    if len(p.files) != 2:
        raise UsageError(p.mode)
    list_fn, out_fn = p.files
    with open(list_fn) as f:
        part_fns = f.read().split()
    if not part_fns:
        raise RuntimeError("Cannot open: " + list_fn)

    # pass 1: sample tables only
    sample_names, sample_counts, part_sizes = [], [], []
    kmer_len, fraction = 0, 1.0
    for i, fn in enumerate(part_fns):
        hdr = dbfile.load_db(fn, dbfile.SAMPLES_ONLY)
        if i == 0:
            kmer_len, fraction = hdr.kmer_length, hdr.fraction
        elif hdr.kmer_length != kmer_len:
            raise RuntimeError("Different k-mer lengths")
        elif hdr.fraction != fraction:
            raise RuntimeError("Different fractions")
        sample_names += hdr.sample_names
        sample_counts += [int(c) for c in hdr.sample_kmer_counts]
        part_sizes.append(hdr.n_samples)

    sampler = None
    if p.sampling_size != 0:
        sampler = sampler_mod.Sampler(
            len(sample_names), p.sampling_size,
            "best" if p.sampling_criterion else "random")
    idx_shifts = np.concatenate([[0], np.cumsum(part_sizes)]).astype(int)

    with open(out_fn, "w", newline="") as ofs:
        ofs.write(csvio.matrix_header(kmer_len, fraction, sample_names))
        ofs.write(csvio.totals_row(sample_counts))

        # parts stay loaded up to a byte budget and are reloaded beyond it
        cache_budget = int(os.environ.get("KMERDB_PARTS_CACHE_MB",
                                          "4096")) << 20
        cached: dict = {}
        cached_bytes = 0

        def get_part(idx):
            nonlocal cached_bytes
            db = cached.get(idx)
            if db is None:
                db = dbfile.load_db(part_fns[idx], dbfile.EVERYTHING)
                nb = int(db.kmers.nbytes + db.kmer_pattern_ids.nbytes
                         + db.pattern_sample_ids.nbytes
                         + db.pattern_offsets.nbytes)
                if cached_bytes + nb <= cache_budget:
                    cached[idx] = db
                    cached_bytes += nb
            return db

        mesh = runtime.active_mesh()
        tier = _grid_tier(part_fns, part_sizes, sample_counts, cache_budget,
                          mesh)
        grid_cells = grid_stream = None
        if tier is not None:
            if tier == "stream":
                grid_stream = fused.grid_rows_streamed(
                    get_part, part_sizes,
                    max_count=max(sample_counts, default=0))
            else:
                grid_cells = fused.grid_group_counts(
                    [get_part(i) for i in range(len(part_fns))])

        prog = log.Progress(max(1, int(sum(part_sizes))))
        for i_row in range(len(part_fns)):
            log.verbose(f"grid row {i_row + 1}/{len(part_fns)}")
            db_row = get_part(i_row)
            row_counts = db_row.sample_kmer_counts
            row_cells = next(grid_stream)[1] if grid_stream is not None \
                else None

            def cell(i_col, db_col):
                if row_cells is not None:
                    return row_cells[i_col]
                if grid_cells is not None:
                    return grid_cells[i_row, i_col]
                if mesh is not None:
                    from ..parallel import sharded
                    if i_col == i_row:
                        return sharded.all2all_counts_sharded(db_row, mesh)
                    return sharded.db2db_counts_sharded(db_row, db_col, mesh)
                if i_col == i_row:
                    return intersect.all2all_counts(db_row)
                return intersect.db2db_counts(db_row, db_col)

            cells = {}
            for i_col in range(i_row):
                db_col = get_part(i_col)
                X = cell(i_col, db_col)
                filt = filters.CombinedFilter(
                    p.metric_filters, p.kmer_filter, row_counts,
                    db_col.sample_kmer_counts, kmer_len)
                if sampler is not None:
                    _cross_to_sampler(
                        sampler, X, filt, p, db_row, db_col,
                        idx_shifts[i_row], idx_shifts[i_col], kmer_len)
                else:
                    cells[i_col] = _filtered_pairs_matrix(X, filt)

            C = cell(i_row, db_row)
            filt = filters.CombinedFilter(p.metric_filters, p.kmer_filter,
                                          row_counts, row_counts, kmer_len)
            if sampler is not None:
                _diag_to_sampler(sampler, C, filt, p, db_row,
                                            idx_shifts[i_row], kmer_len)
                continue
            diag = []
            for r in range(db_row.n_samples):
                row = C[r, :r]
                nz = np.flatnonzero(row * filt.mask_row(row, r))
                diag.append((nz, row[nz]))
            cells[i_row] = diag

            # each row's survivors of every cell, shifted to global columns
            for r in range(db_row.n_samples):
                g = idx_shifts[i_row] + r
                cs, vs = [], []
                for i_col in range(i_row + 1):
                    c, v = cells[i_col][r]
                    if c.size:
                        cs.append(c.astype(np.int64)
                                  + (idx_shifts[i_col] + 1))
                        vs.append(v)
                cols = np.concatenate(cs) if cs \
                    else np.empty(0, dtype=np.int64)
                vals = np.concatenate(vs) if vs \
                    else np.empty(0, dtype=np.uint32)
                ofs.write(csvio.sparse_row_pairs_arrays(
                    sample_names[g], sample_counts[g], cols, vals))
                prog.step()

        if sampler is not None:
            for g in range(len(sample_names)):
                ofs.write(csvio.sparse_row_pairs(
                    sample_names[g], sample_counts[g], sampler.row_pairs(g)))
                prog.step()
        prog.done()


def _filtered_pairs_matrix(X, filt):
    """Per-row survivor (cols, values) array pairs (ascending cols)."""
    out = []
    for r in range(X.shape[0]):
        row = X[r]
        keep = filt.mask_row(row, r)
        nz = np.flatnonzero(row * keep)
        out.append((nz, row[nz]))
    return out


def _cross_to_sampler(sampler, X, filt, p, db_row, db_col, row_shift,
                      col_shift, kmer_len):
    crit = p.sampling_criterion or (lambda c, a, b, k: 1.0)
    rc = db_row.sample_kmer_counts
    cc = db_col.sample_kmer_counts
    for r in range(X.shape[0]):
        row = X[r]
        nz = np.flatnonzero(row)
        if nz.size == 0:
            continue
        keep = filt.mask_row(row[nz], r, nz)
        for j in nz[keep]:
            v = int(row[j])
            score = float(crit(v, int(rc[r]), int(cc[j]), kmer_len))
            sampler.add(row_shift + r, col_shift + int(j), v, score)
            sampler.add(col_shift + int(j), row_shift + r, v, score)


def _diag_to_sampler(sampler, C, filt, p, db_row, shift, kmer_len):
    sampler_mod.feed_lower_triangle(
        sampler, C, filt, p.sampling_criterion, db_row.sample_kmer_counts,
        kmer_len, shift=shift)
