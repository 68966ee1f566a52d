"""Mode drivers of the port that differ from kmerdb_tpu's.

Only ``all2all`` over a database has a device tier in the port so far;
it reuses the row format and filters of kmerdb_tpu/cli/consoles.py, so the
two packages write the same bytes.  Host-only modes run kmerdb_tpu's
runners directly (cli/main.py).
"""

import os
import time

from ..host import consoles as host_consoles
from ..host import csvio, dbfile, log, native, params
from ..ops import intersect

#: above this many samples all2all streams row stripes by default
STREAM_MIN_SAMPLES = 16384


def run_all2all(p):
    """`all2all [-sparse ...] <database> <common_table>`: the dense or
    filtered-sparse lower triangle of the common-k-mer matrix
    (kmerdb_tpu/cli/consoles.run_all2all without its mesh tier).  Large
    collections stream row stripes from the card into the writer
    (_stream_rows); the rest compute the whole matrix on the host or the
    card (ops/intersect.all2all_counts).  A failure of the streamed route
    propagates: nothing is recomputed on another route."""
    if len(p.files) != 2:
        raise params.UsageError(p.mode)
    db_filename, out_filename = p.files
    t0 = time.perf_counter()
    db = dbfile.load_db(db_filename, dbfile.PATTERNS)
    t1 = time.perf_counter()
    log.verbose(f"Database loaded in {t1 - t0:.3f}s: "
                f"{db.n_samples} samples, {db.n_patterns} patterns")

    with open(out_filename, "w", newline="") as ofs:
        ofs.write(csvio.matrix_header(db.kmer_length, db.fraction,
                                      db.sample_names))
        ofs.write(csvio.totals_row(db.sample_kmer_counts))
        filt = host_consoles._matrix_filter(p, db) if p.sparse_out else None
        prog = log.Progress(db.n_samples)

        def emit(i, full_row):
            host_consoles._emit_matrix_row(
                ofs, db.sample_names[i], int(db.sample_kmer_counts[i]),
                full_row[:i], i, filt)
            prog.step()

        if _stream_rows(db):
            # the card counts the filter's survivors and pulls only their
            # tiles; emit() re-applies the exact filter, metric filters
            # included, which can only narrow the count bounds further
            cell_bounds = None
            if filt is not None:
                lo, hi = p.kmer_filter.bounds
                cell_bounds = (max(1, int(lo)), min(0xFFFFFFFF, int(hi)))
            from ..ops import device_a2a
            device_a2a.all2all_device_rows(db, emit, cell_bounds=cell_bounds)
        else:
            C = intersect.all2all_counts(db)
            log.verbose(f"Similarity matrix computed in "
                        f"{time.perf_counter() - t1:.3f}s")
            for i in range(db.n_samples):
                emit(i, C[i])
        prog.done()


def _stream_rows(db) -> bool:
    """Whether all2all streams row stripes (ops/device_a2a.
    all2all_device_rows): KMERDB_A2A_STREAM=1/0 forces it either way;
    unset, above STREAM_MIN_SAMPLES samples with the host runtime and a
    CUDA card (kmerdb_tpu/cli/consoles._stream_rows, single card)."""
    if db.n_samples == 0:
        return False
    env = os.environ.get("KMERDB_A2A_STREAM", "")
    if env in ("0", "1"):
        return env == "1"
    # the size first: a small run never pays torch's import
    if db.n_samples <= STREAM_MIN_SAMPLES or not native.available:
        return False
    import torch
    return torch.cuda.is_available()
