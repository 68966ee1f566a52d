"""Mode runners of the port that differ from kmerdb_tpu's: ``all2all``
over a database and ``new2all``, which have device tiers
(``all2all-parts`` is cli/parts.py).  They reuse the row formats, filters
and sample loading of kmerdb_tpu/cli/consoles.py, so the two packages
write the same bytes.  Host-only modes, ``one2all`` among them, run
kmerdb_tpu's runners directly (cli/main.py).
"""

import os
import time

import numpy as np

from ..host import consoles as host_consoles
from ..host import csvio, dbfile, fasta, loader, log, native, params
from ..ops import intersect

#: queries per new2all batch (kmerdb_tpu's flush size)
N2A_FLUSH = 512

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


def run_new2all(p):
    """`new2all [-sparse ...] <database> <samples> <table>`: the common
    k-mer counts of each new sample against every database sample
    (kmerdb_tpu/cli/consoles.run_new2all without its mesh tier).  Queries
    go to ops/intersect.many2all_counts in batches of N2A_FLUSH, and rows
    are written in input order, dense or filtered sparse."""
    if len(p.files) != 3:
        raise params.UsageError(p.mode)
    db_filename, samples_arg, out_filename = p.files
    db = dbfile.load_db(db_filename, dbfile.EVERYTHING)

    with open(out_filename, "w", newline="") as ofs:
        ofs.write(csvio.matrix_header(db.kmer_length, db.fraction,
                                      db.sample_names))
        ofs.write(csvio.totals_row(db.sample_kmer_counts))

        def flush(names, queries):
            M = intersect.many2all_counts(db, queries)
            filt = None
            if p.sparse_out:
                # one filter for the batch: its rows are the queries
                filt = host_consoles._matrix_filter(
                    p, db, query_counts=np.array(
                        [q.size for q in queries], dtype=np.uint32))
            for i, (name, q) in enumerate(zip(names, queries)):
                sims = M[i]
                if p.sparse_out:
                    nz = np.flatnonzero(sims)
                    kept = nz[filt.mask_row(sims[nz], i, nz)]
                    ofs.write(csvio.sparse_row_pairs(
                        name, int(q.size),
                        zip((kept + 1).tolist(), sims[kept].tolist())))
                else:
                    ofs.write(csvio.dense_row(name, int(q.size), sims))

        # percent progress when the list length is known up front; a
        # multisample FASTA logs per batch
        prog = None
        if not p.multisample_fasta and not fasta.is_fasta_path(samples_arg):
            try:
                prog = log.Progress(len(fasta.read_file_list(samples_arg)))
            except OSError:
                pass

        names, queries = [], []
        n_done = 0
        samples = loader.iter_samples(
            samples_arg, p.input_format, db.kmer_length, db.fraction,
            db.start_fraction, db.alphabet_name, p.multisample_fasta,
            num_threads=p.num_threads)
        for s in samples:
            names.append(s.name)
            # loaders give sorted unique k-mers for genome and KMC input;
            # checking costs one pass, np.unique always a sort
            q = s.kmers
            if q.size > 1 and not bool(np.all(q[1:] > q[:-1])):
                q = np.unique(q)
            queries.append(q)
            if len(names) < N2A_FLUSH:
                continue
            flush(names, queries)
            n_done += len(names)
            _progress(prog, len(names), n_done)
            names, queries = [], []
        if names:
            flush(names, queries)
            n_done += len(names)
            _progress(prog, len(names), n_done)
        if prog is not None:
            prog.done()


def _progress(prog, n: int, n_done: int) -> None:
    if prog is not None:
        prog.step(n)
    else:
        log.verbose(f"{n_done} queries processed")
