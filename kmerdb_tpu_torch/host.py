"""The host code the port shares with kmerdb_tpu, named in one place.

Database container and file format, the C++ host runtime, CSV writers,
filters, the sampler, sample loading, logging, argument parsing, the
host-only console runners (``one2all`` among them), the host stages of
the query and db2db kernels (probes, apply, pattern-pair intersection,
chunk plans), the row writers of ``all2all-parts``, the cost constants and
the benchmark corpus are not TPU code, so the port imports them instead of
copying them.  None of these modules imports jax when it loads
(kmerdb_tpu/_jaxinit.py is lazy), and the port calls none of their device
branches: cli/main.py refuses the options that reach them.
"""

from kmerdb_tpu.cli import consoles, loader, params
from kmerdb_tpu.cli import main as cli_main
from kmerdb_tpu.cli import parts
from kmerdb_tpu.io import dbfile, fasta
from kmerdb_tpu.models.database import KmerPatternDb
from kmerdb_tpu.ops import costcal
from kmerdb_tpu.ops import intersect
from kmerdb_tpu.utils import bench_corpus, csvio, filters, log, native
from kmerdb_tpu.utils import sampler

__all__ = ["KmerPatternDb", "bench_corpus", "cli_main", "consoles",
           "costcal", "csvio", "dbfile", "fasta", "filters", "intersect",
           "loader", "log", "native", "params", "parts", "sampler"]
