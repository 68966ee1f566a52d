"""Mode drivers of the port that differ from kmerdb_tpu's.

Only ``all2all`` over a database has a device tier in the port so far;
it reuses the row format and filters of kmerdb_tpu/cli/consoles.py, so the
two packages write the same bytes.  Host-only modes run kmerdb_tpu's
runners directly (cli/main.py).
"""

import time

from ..host import consoles as host_consoles
from ..host import csvio, dbfile, log, params
from ..ops import intersect


def run_all2all(p):
    """`all2all [-sparse ...] <database> <common_table>`: the dense or
    filtered-sparse lower triangle of the common-k-mer matrix
    (kmerdb_tpu/cli/consoles.run_all2all without its streamed and mesh
    tiers)."""
    if len(p.files) != 2:
        raise params.UsageError(p.mode)
    db_filename, out_filename = p.files
    t0 = time.perf_counter()
    db = dbfile.load_db(db_filename, dbfile.PATTERNS)
    t1 = time.perf_counter()
    log.verbose(f"Database loaded in {t1 - t0:.3f}s: "
                f"{db.n_samples} samples, {db.n_patterns} patterns")
    C = intersect.all2all_counts(db)
    log.verbose(f"Similarity matrix computed in "
                f"{time.perf_counter() - t1:.3f}s")

    with open(out_filename, "w", newline="") as ofs:
        ofs.write(csvio.matrix_header(db.kmer_length, db.fraction,
                                      db.sample_names))
        ofs.write(csvio.totals_row(db.sample_kmer_counts))
        filt = host_consoles._matrix_filter(p, db) if p.sparse_out else None
        prog = log.Progress(db.n_samples)
        for i in range(db.n_samples):
            host_consoles._emit_matrix_row(
                ofs, db.sample_names[i], int(db.sample_kmer_counts[i]),
                C[i, :i], i, filt)
            prog.step()
        prog.done()
