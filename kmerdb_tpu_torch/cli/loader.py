"""Sample loading orchestration (the reference's LoaderEx role).

Turns the CLI "samples" argument into an ordered stream of
(sample_name, sorted-unique k-mer array) pairs, honoring the three
input formats and multisample-fasta handling
(src/loader_ex.cpp, src/input_file_factory.h).

Parallel ingest: the reference hides parse/extract latency behind a
prefetcher + reader-thread pipeline (loader_ex.cpp:55-66).  Here the
same role is played by a process pool (`workers` > 1): per-path
extraction fans out across cores while results stream back in input
order.  Workers use the spawn start method so no TPU device handles
leak across fork; on single-core hosts the loader stays serial.
"""

import os
import sys

import numpy as np

from ..ops.alphabet import get_alphabet
from ..io import fasta, ingest, minhash_file
from . import params as P


class LoadedSample:
    __slots__ = ("name", "kmers", "kmer_length", "fraction", "path")

    def __init__(self, name, kmers, kmer_length, fraction, path=""):
        self.name = name
        self.kmers = kmers
        self.kmer_length = kmer_length
        self.fraction = fraction
        self.path = path

    def __getstate__(self):
        return (self.name, self.kmers, self.kmer_length, self.fraction,
                self.path)

    def __setstate__(self, state):
        (self.name, self.kmers, self.kmer_length, self.fraction,
         self.path) = state


def _load_path(path: str, input_format: str, kmer_length: int,
               fraction: float, fraction_start: float, alphabet_name: str,
               multisample: bool) -> list[LoadedSample]:
    """All samples contributed by one input path (possibly several for
    multisample FASTA; empty list when the path cannot be opened)."""
    alphabet = get_alphabet(alphabet_name)
    out: list[LoadedSample] = []
    if input_format == P.GENOME:
        real = fasta.resolve_input_path(path)
        if real is None:
            print(f"failed:{path}", file=sys.stderr)
            return out
        headers, seqs = fasta.split_contigs(fasta.read_raw(real))
        if multisample:
            for h, s in zip(headers, seqs):
                kmers = ingest.extract_sample_kmers(
                    [s], kmer_length, alphabet, fraction, fraction_start)
                out.append(LoadedSample(h.decode(), kmers, kmer_length,
                                        fraction, path))
        else:
            kmers = ingest.extract_sample_kmers(
                seqs, kmer_length, alphabet, fraction, fraction_start)
            out.append(LoadedSample(fasta.sample_name_from_path(path),
                                    kmers, kmer_length, fraction, path))
    elif input_format == P.MINHASH:
        res = minhash_file.load(path)
        if res is None:
            print(f"failed:{path}", file=sys.stderr)
            return out
        kmers, k, frac = res
        out.append(LoadedSample(fasta.sample_name_from_path(path), kmers,
                                k, frac, path))
    elif input_format == P.KMC:
        from ..io import kmc
        res = kmc.load(path, fraction, fraction_start)
        if res is None:
            print(f"failed:{path}", file=sys.stderr)
            return out
        kmers, k = res
        kmers = np.sort(kmers, kind="stable")
        out.append(LoadedSample(fasta.sample_name_from_path(path), kmers,
                                k, fraction, path))
    else:
        raise ValueError(f"unsupported input format {input_format}")
    return out


def _resolve_workers(num_threads: int) -> int:
    # Never spawn a pool from inside a worker process: a library
    # consumer whose __main__ lacks the standard multiprocessing guard
    # would otherwise re-execute their script in every spawn child and
    # fork-bomb.  (python -m kmerdb_tpu is guarded; this protects
    # programmatic callers.)
    import multiprocessing as mp
    proc = mp.current_process()
    if proc.daemon or proc.name != "MainProcess":
        return 1
    # explicit -t is honored as given (reference semantics); the
    # default scales to hardware concurrency
    if num_threads > 0:
        return num_threads
    return os.cpu_count() or 1


def iter_samples(samples_arg: str, input_format: str, kmer_length: int,
                 fraction: float, fraction_start: float, alphabet_name: str,
                 multisample: bool, num_threads: int = 0):
    """Yield LoadedSample in deterministic input order.

    num_threads follows the reference's -t semantics (0 = hardware
    concurrency); >1 fans per-path ingest across a process pool.
    """
    get_alphabet(alphabet_name)  # validate early

    if input_format == P.GENOME and fasta.is_fasta_path(samples_arg):
        paths = [samples_arg]
    else:
        paths = fasta.read_file_list(samples_arg)

    args = (input_format, kmer_length, fraction, fraction_start,
            alphabet_name, multisample)
    workers = _resolve_workers(num_threads)
    if workers <= 1 or len(paths) < 2:
        for path in paths:
            yield from _load_path(path, *args)
        return

    import concurrent.futures as cf
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with cf.ProcessPoolExecutor(max_workers=min(workers, len(paths)),
                                mp_context=ctx) as ex:
        for samples in ex.map(_load_path, paths,
                              *[[a] * len(paths) for a in args],
                              chunksize=4):
            yield from samples
