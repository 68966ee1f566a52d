"""Mode drivers (counterpart of kmerdb_tpu/cli/consoles.py, without its
``-from-fasta`` forms and its sharded build, which cli/main.py refuses).

Each run_* takes a parsed Params and writes the same bytes as kmerdb_tpu.
``build``, ``minhash``, ``one2all`` and ``distance`` run on the host;
``all2all`` and ``all2all-sp`` over a database and ``new2all`` choose a
host or device tier in ops/intersect.py, or run over the device mesh that
``-mesh`` asks for (parallel/sharded.py); ``all2all-parts`` is cli/parts.py.
"""

import os
import sys
import time

import numpy as np

from ..io import dbfile, fasta, ingest, minhash_file
from ..models import builder
from ..models.database import KmerPatternDb
from ..ops import intersect
from ..ops.alphabet import get_alphabet
from ..parallel import runtime
from ..utils import csvio, log, native
from ..utils.filters import AVAILABLE_METRICS, CombinedFilter
from ..utils.num2str import format_double_cpp, num2str_float
from ..utils.sampler import Sampler, feed_lower_triangle
from . import params as P
from .loader import iter_samples
from .params import UsageError

#: samples per add_samples batch (memory bound)
_BUILD_BATCH = 1024

#: queries per new2all batch (kmerdb_tpu's flush size)
N2A_FLUSH = 512

#: above this many samples all2all streams row stripes by default
STREAM_MIN_SAMPLES = 16384


def _build_batch_size() -> int:
    """KMERDB_BUILD_BATCH overrides the batch bound (read per call).  The
    database bytes do not depend on it."""
    return int(os.environ.get("KMERDB_BUILD_BATCH", _BUILD_BATCH))


def _log(p, *args):
    print(*args, file=sys.stderr)


# ---------------------------------------------------------------------------
# build / minhash
# ---------------------------------------------------------------------------

def run_build(p):
    if len(p.files) != 2:
        raise UsageError(p.mode)
    samples_arg, db_filename = p.files

    if p.extend_db:
        db = dbfile.load_db(db_filename, dbfile.EVERYTHING)
        kmer_length = db.kmer_length
        fraction = db.fraction
        fraction_start = db.start_fraction
        alphabet_name = db.alphabet_name
    else:
        # the reference NEVER assigns its db's startFraction: it is
        # constructed as 0 (kmer_db.h:63) and nothing sets it, so the
        # persisted value is always 0 and query-time re-filtering
        # (one2all/new2all/extend ingest) uses the [0, fraction)
        # window regardless of -f-start.  -f-start only shapes the
        # build-time ingest below.  Replicated for parity.
        db = KmerPatternDb(kmer_length=0, fraction=p.fraction,
                           start_fraction=0.0,
                           alphabet_name=p.alphabet_name)
        kmer_length = p.kmer_length
        fraction = p.fraction
        fraction_start = p.fraction_start
        alphabet_name = p.alphabet_name

    timing = os.environ.get("KMERDB_TIMING") == "1"
    t0 = time.perf_counter()
    batch = []
    for s in iter_samples(samples_arg, p.input_format, kmer_length,
                          fraction, fraction_start, alphabet_name,
                          p.multisample_fasta,
                          num_threads=p.num_threads):
        if db.kmer_length == 0:
            # first sample fixes k/fraction (AbstractKmerDb::addKmers,
            # kmer_db.h:112-125) — relevant for minhash/KMC inputs
            db.kmer_length = s.kmer_length
            db.fraction = s.fraction
        elif s.kmer_length != db.kmer_length:
            raise RuntimeError("sample k-mer length differs from database")
        elif s.fraction != db.fraction:
            # kmer_db.h:118-120: "adding kmers of different minhash
            # fraction" is an error (mixed-fraction .minhash inputs)
            raise RuntimeError(
                "sample minhash fraction differs from database")
        batch.append((s.name, s.kmers))
        if len(batch) >= _build_batch_size():
            db = builder.add_samples(db, batch)
            batch = []
    t1 = time.perf_counter()
    if batch or db.n_samples == 0:
        db = builder.add_samples(db, batch)
    t2 = time.perf_counter()
    if db.n_samples == 0:
        _log(p, "WARNING: no samples were ingested (check input paths; "
                "relative list entries resolve against the working "
                "directory)")
    dbfile.save_db(db, db_filename)
    if timing:
        _log(p, f"TIMING ingest={t1 - t0:.2f}s add={t2 - t1:.2f}s "
                f"save={time.perf_counter() - t2:.2f}s")
    _log(p, f"Database stored: {db.n_samples} samples, {db.n_kmers} kmers, "
            f"{db.n_patterns} patterns")


def run_minhash(p):
    if len(p.files) != 1:
        raise UsageError(p.mode)
    # the reference's minhash console hardcodes startValue=0 when
    # building its filter (console_minhash.cpp:19) — -f-start is
    # silently ignored in this mode; replicated for parity
    for s in iter_samples(p.files[0], p.input_format, p.kmer_length,
                          p.fraction, 0.0, p.alphabet_name,
                          p.multisample_fasta,
                          num_threads=p.num_threads):
        # store next to the input path (console_minhash.cpp:45); stored
        # fraction is the CLI fraction
        minhash_file.store(s.path, s.kmers, s.kmer_length, p.fraction)


# ---------------------------------------------------------------------------
# all2all
# ---------------------------------------------------------------------------

def _matrix_filter(p, db, query_counts=None):
    qc = db.sample_kmer_counts if query_counts is None else query_counts
    return CombinedFilter(p.metric_filters, p.kmer_filter,
                          qc, db.sample_kmer_counts, db.kmer_length)


def _emit_matrix_row(ofs, name, cnt, row, i, filt):
    """One all2all CSV body row (dense, or filter-masked sparse): the
    single home of the row byte format."""
    if filt is not None:
        keep = filt.mask_row(row, i)
        row = np.where(keep, row, 0)
        ofs.write(csvio.sparse_row(name, cnt, row))
    else:
        ofs.write(csvio.dense_row(name, cnt, row))


def run_all2all(p):
    """`all2all [-sparse ...] <database> <common_table>`: the dense or
    filtered-sparse lower triangle of the common-k-mer matrix
    (kmerdb_tpu/cli/consoles.run_all2all).  Large collections stream row
    stripes from the card, or from the slots of a mesh, into the writer
    (_stream_rows); the rest compute the whole matrix on the host, the
    card (ops/intersect.all2all_counts) or the mesh
    (parallel/sharded.all2all_counts_sharded).  A failure of the streamed
    route propagates: nothing is recomputed on another route."""
    if len(p.files) != 2:
        raise UsageError(p.mode)
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
        filt = _matrix_filter(p, db) if p.sparse_out else None
        prog = log.Progress(db.n_samples)

        def emit(i, full_row):
            _emit_matrix_row(
                ofs, db.sample_names[i], int(db.sample_kmer_counts[i]),
                full_row[:i], i, filt)
            prog.step()

        mesh = runtime.active_mesh()
        if _stream_rows(db, mesh):
            # the device applies the count bounds (the card pulls only the
            # survivors' tiles, a mesh zeroes the other cells); emit()
            # re-applies the exact filter, metric filters included, which
            # can only narrow the count bounds further
            cell_bounds = None
            if filt is not None:
                lo, hi = p.kmer_filter.bounds
                cell_bounds = (max(1, int(lo)), min(0xFFFFFFFF, int(hi)))
            if mesh is not None:
                from ..parallel import sharded
                sharded.all2all_rows_sharded(db, mesh, emit,
                                             cell_bounds=cell_bounds)
            else:
                from ..ops import device_a2a
                device_a2a.all2all_device_rows(db, emit,
                                               cell_bounds=cell_bounds)
        else:
            C = _all2all_matrix(db, mesh)
            log.verbose(f"Similarity matrix computed in "
                        f"{time.perf_counter() - t1:.3f}s")
            for i in range(db.n_samples):
                emit(i, C[i])
        prog.done()


def _all2all_matrix(db, mesh) -> np.ndarray:
    """The whole count matrix: over the mesh when there is one, else by
    the tier ops/intersect.all2all_counts chooses."""
    if mesh is not None:
        from ..parallel import sharded
        return sharded.all2all_counts_sharded(db, mesh)
    return intersect.all2all_counts(db)


def _stream_rows(db, mesh=None) -> bool:
    """Whether all2all streams row stripes (ops/device_a2a.
    all2all_device_rows, or parallel/sharded.all2all_rows_sharded over a
    mesh): KMERDB_A2A_STREAM=1/0 forces it either way; unset, above
    STREAM_MIN_SAMPLES samples with the host runtime and a mesh or a CUDA
    card (kmerdb_tpu/cli/consoles._stream_rows)."""
    if db.n_samples == 0:
        return False
    env = os.environ.get("KMERDB_A2A_STREAM", "")
    if env in ("0", "1"):
        return env == "1"
    # the size first: a small run never pays torch's import
    if db.n_samples <= STREAM_MIN_SAMPLES or not native.available:
        return False
    if mesh is not None:
        return True
    import torch
    return torch.cuda.is_available()


def run_all2all_sp(p):
    """`all2all-sp [-min ...] [-max ...] [-sample-rows ...] <database>
    <common_table>`: the filtered sparse lower triangle, like
    `all2all -sparse`, with optional row sampling
    (kmerdb_tpu/cli/consoles.run_all2all_sp over a database)."""
    if len(p.files) != 2:
        raise UsageError(p.mode)
    db_filename, out_filename = p.files
    db = dbfile.load_db(db_filename, dbfile.PATTERNS)
    C = _all2all_matrix(db, runtime.active_mesh())
    filt = _matrix_filter(p, db)

    sampler = None
    if p.sampling_size != 0:
        sampler = Sampler(db.n_samples, p.sampling_size,
                          "best" if p.sampling_criterion else "random")

    with open(out_filename, "w", newline="") as ofs:
        ofs.write(csvio.matrix_header(db.kmer_length, db.fraction,
                                      db.sample_names))
        ofs.write(csvio.totals_row(db.sample_kmer_counts))
        prog = log.Progress(db.n_samples)
        if sampler is not None:
            feed_lower_triangle(sampler, C, filt, p.sampling_criterion,
                                db.sample_kmer_counts, db.kmer_length)
        for i in range(db.n_samples):
            name, cnt = db.sample_names[i], int(db.sample_kmer_counts[i])
            if sampler is not None:
                ofs.write(csvio.sparse_row_pairs(name, cnt,
                                                 sampler.row_pairs(i)))
            else:
                row = C[i, :i]
                row = np.where(filt.mask_row(row, i), row, 0)
                ofs.write(csvio.sparse_row(name, cnt, row))
            prog.step()
        prog.done()


def run_new2all(p):
    """`new2all [-sparse ...] <database> <samples> <table>`: the common
    k-mer counts of each new sample against every database sample
    (kmerdb_tpu/cli/consoles.run_new2all).  Queries go in batches of
    N2A_FLUSH to ops/intersect.many2all_counts, or, under a mesh, to
    parallel/sharded.many2all_counts_sharded, and rows are written in input
    order, dense or filtered sparse."""
    if len(p.files) != 3:
        raise UsageError(p.mode)
    db_filename, samples_arg, out_filename = p.files
    db = dbfile.load_db(db_filename, dbfile.EVERYTHING)

    with open(out_filename, "w", newline="") as ofs:
        ofs.write(csvio.matrix_header(db.kmer_length, db.fraction,
                                      db.sample_names))
        ofs.write(csvio.totals_row(db.sample_kmer_counts))

        mesh = runtime.active_mesh()

        def flush(names, queries):
            if mesh is not None:
                from ..parallel import sharded
                M = sharded.many2all_counts_sharded(db, queries, mesh)
            else:
                M = intersect.many2all_counts(db, queries)
            filt = None
            if p.sparse_out:
                # one filter for the batch: its rows are the queries
                filt = _matrix_filter(
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
        samples = iter_samples(
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


def run_one2all(p):
    if len(p.files) != 3:
        raise UsageError(p.mode)
    db_filename, sample_arg, out_filename = p.files
    db = dbfile.load_db(db_filename, dbfile.EVERYTHING)

    if p.input_format == P.GENOME:
        contigs = fasta.load_sample_contigs(sample_arg)
        if contigs is None:
            raise RuntimeError(f"Cannot open sample file: {sample_arg}")
        kmers = ingest.extract_sample_kmers(
            contigs, db.kmer_length, get_alphabet(db.alphabet_name),
            db.fraction, db.start_fraction)
    elif p.input_format == P.MINHASH:
        res = minhash_file.load(sample_arg)
        if res is None:
            raise RuntimeError(f"Cannot open sample file: {sample_arg}")
        kmers, k, _ = res
        if k != db.kmer_length:
            raise RuntimeError("Sample and database k-mer length differ")
    else:
        from ..io import kmc
        res = kmc.load(sample_arg, db.fraction, db.start_fraction)
        if res is None:
            raise RuntimeError(f"Cannot open sample file: {sample_arg}")
        kmers, k = res
        if k != db.kmer_length:
            # console_one2all.cpp:58-67: KMC sample k must match the db
            raise RuntimeError("Sample and database k-mer length differ")
        kmers = np.unique(kmers)

    sims = intersect.one2all_counts(db, kmers)
    with open(out_filename, "w", newline="") as ofs:
        # console_one2all.cpp:86-92: totals via ostream, no final newline
        ofs.write(csvio.matrix_header(db.kmer_length, db.fraction,
                                      db.sample_names))
        ofs.write(csvio.totals_row(db.sample_kmer_counts))
        ofs.write(f"{sample_arg},{kmers.size},"
                  + "".join(f"{int(v)}," for v in sims))


# ---------------------------------------------------------------------------
# distance
# ---------------------------------------------------------------------------

def run_distance(p):
    if len(p.files) < 2:
        raise UsageError(p.mode)
    in_name, out_name = p.files[0], p.files[1]
    metric = AVAILABLE_METRICS[p.metric_name]

    with open(in_name) as fin, open(out_name, "w", newline="") as fout:
        header = fin.readline().rstrip("\n")
        # 'kmer-length: K fraction: F ,db-samples ,names...'
        # (console_distance.cpp:63-96 streams this with a line buffer;
        # malformed headers must fail as a diagnosed error, not a raw
        # IndexError/ValueError)
        try:
            toks = header.split()
            if toks[0] != "kmer-length:" or toks[2] != "fraction:":
                raise ValueError("unexpected field names")
            kmer_length = int(toks[1])
            fraction = float(toks[3])
            # remainder after the 5th whitespace token (',db-samples')
            idx = 0
            for _ in range(5):
                while header[idx] == " ":
                    idx += 1
                while idx < len(header) and header[idx] != " ":
                    idx += 1
            rest = header[idx:]
        except (IndexError, ValueError) as e:
            raise IOError(f"Cannot parse similarity matrix header of "
                          f"{in_name}: {e}") from e
        names = [t for t in rest.replace(",", " ").split()]
        if not p.phylip_out:
            fout.write(f"kmer-length: {kmer_length} fraction: "
                       f"{format_double_cpp(fraction)}{rest}\n")

        totals_line = fin.readline().rstrip("\n")
        toks = totals_line.replace(",", " ").split()
        try:
            db_counts = [int(t) for t in toks[2:]]
        except ValueError as e:
            raise IOError(f"Cannot parse total-kmers row of "
                          f"{in_name}: {e}") from e
        if p.phylip_out:
            fout.write(f"{len(db_counts)}\n")

        sparse_out = p.sparse_out and not p.phylip_out
        triangle = False
        db_counts_np = np.asarray(db_counts, dtype=np.uint32)
        fast = native.available and p.metric_name in native.METRIC_IDS

        for row_id, line in enumerate(fin):
            line = line.rstrip("\n")
            cpos = line.find(",")
            query_name = line[:cpos]
            rest = line[cpos + 1:]
            cpos = rest.find(",")
            query_count = int(rest[:cpos]) if cpos >= 0 else int(rest or 0)
            body = rest[cpos + 1:] if cpos >= 0 else ""

            filt = CombinedFilter(p.metric_filters, p.kmer_filter,
                                  [query_count], db_counts, kmer_length)

            toks = body.split(",")
            if toks and toks[-1] == "":
                toks.pop()
            has_pairs = ":" in body

            dense = np.zeros(len(db_counts), dtype=np.int64)
            sparse_entries = []
            num_read = len(toks)
            if not has_pairs and not sparse_out:
                # dense fast path
                if toks:
                    dense[:len(toks)] = np.array(toks, dtype=np.int64)
            else:
                num_read = 0
                for tok in toks:
                    if not tok:
                        continue
                    if ":" in tok:
                        c, v = tok.split(":")
                        col = int(c) - 1
                        common = int(v)
                        if p.phylip_out:
                            dense[col] = common
                        else:
                            sparse_out = True
                            if common > 0 and filt(common, 0, col):
                                sparse_entries.append((col, common))
                    else:
                        common = int(tok)
                        if sparse_out:
                            if common > 0 and filt(common, 0, num_read):
                                sparse_entries.append((num_read, common))
                        else:
                            dense[num_read] = common
                    num_read += 1

            if row_id == 0:
                empty_diag = (len(sparse_entries) == 0) if sparse_out \
                    else (dense[0] == 0)
                if query_name == names[0] and empty_diag:
                    triangle = True

            if sparse_out:
                out_cells = "".join(
                    f"{col + 1}:{num2str_float(metric(common, query_count, db_counts[col], kmer_length))},"
                    for col, common in sparse_entries)
                fout.write(f"{query_name},{out_cells}\n")
            else:
                n_out = num_read if p.phylip_out \
                    else (row_id if triangle else len(dense))
                delim = " " if p.phylip_out else ","
                if fast and n_out > 0:
                    mvals = native.metric_row(
                        p.metric_name, dense[:n_out], query_count,
                        db_counts_np[:n_out], kmer_length)
                    body_out = native.row_double6(mvals, delim).decode()
                else:
                    body_out = "".join(
                        num2str_float(metric(int(dense[j]), query_count,
                                             db_counts[j], kmer_length))
                        + delim for j in range(n_out))
                fout.write(query_name + delim + body_out + "\n")
