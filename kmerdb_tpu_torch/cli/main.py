"""Entry point: `python -m kmerdb_tpu_torch <mode> [options] <args>`.

The options, usage text and exit codes are kmerdb_tpu's
(kmerdb_tpu/cli/main.py): exit 0 on success, 255 on any error.  ``build``,
``minhash``, ``distance`` and ``one2all`` run on the host; ``all2all``
and ``all2all-sp`` over a database, ``new2all`` and ``all2all-parts``
choose a host or device tier (cli/consoles.py, cli/parts.py), or run over
the device mesh that ``-mesh <n|auto>`` or KMERDB_MESH asks for
(parallel/).  Settings whose code is not ported yet (the ``-from-fasta``
forms, ``build`` over a mesh, the multi-process runtime of KMERDB_COORD,
the device build and ingest) are refused with an error rather than run on
some other route.
"""

import os
import sys

from ..parallel import runtime
from ..utils import log, native
from . import consoles, parts
from .params import MODES, UsageError, parse_args

_RUNNERS = {
    "build": consoles.run_build,
    "minhash": consoles.run_minhash,
    "distance": consoles.run_distance,
    "one2all": consoles.run_one2all,
    "all2all": consoles.run_all2all,
    "all2all-sp": consoles.run_all2all_sp,
    "new2all": consoles.run_new2all,
    "all2all-parts": parts.run_all2all_parts,
}

#: settings that select kmerdb_tpu device code the port has no
#: counterpart of yet
_REFUSED_ENV = {
    "KMERDB_BUILD_DEVICE": "1",
    "KMERDB_DEVICE_INGEST": "1",
    "KMERDB_A2A_ENGINE": "bf16",
}


_MODE_HELP = {
    "build": """Building a database:
    kmer-db-tpu build [-k <kmer-length>] [-f <fraction>] [-f-start <value>]
        [-multisample-fasta] [-extend] [-alphabet <type>] [-preserve-strand]
        [-t <threads>] <samples> <database>
    kmer-db-tpu build -from-kmers [-f <fraction>] [-extend] <samples> <database>
    kmer-db-tpu build -from-minhash [-extend] <samples> <database>
  samples: FASTA file (fa/fna/fasta[.gz]) or list of FASTA/KMC/minhash paths
  -k  k-mer length (default 18; max depends on alphabet, 31 for nt)
  -f  minhash fraction (default 1)
  -alphabet  nt | aa | aa12_mmseqs | aa11_diamond | aa6_dayhoff""",
    "all2all": """Counting common k-mers for all samples in the database:
    kmer-db-tpu all2all [-buffer <mb>] [-t <threads>]
        [-sparse [-min [<criterion>:]<value>]* [-max [<criterion>:]<value>]*]
        <database> <common_table>
    kmer-db-tpu all2all -from-fasta [build ingest options]
        <samples> <common_table>     (fused pipeline, no database)""",
    "all2all-sp": """Counting common k-mers (sparse computation):
    kmer-db-tpu all2all-sp [-min ...]* [-max ...]*
        [-sample-rows [<criterion>:]<count>] <database> <common_table>
    kmer-db-tpu all2all-sp -from-fasta [build ingest options]
        [-min ...]* [-max ...]* [-sample-rows ...]
        <samples> <common_table>     (fused pipeline, no database)""",
    "all2all-parts": """Counting common k-mers over database parts:
    kmer-db-tpu all2all-parts [-min ...]* [-max ...]*
        [-sample-rows [<criterion>:]<count>] <db_list> <common_table>""",
    "new2all": """Counting common k-mers: new samples versus database:
    kmer-db-tpu new2all [-multisample-fasta | -from-kmers | -from-minhash]
        [-sparse [-min ...]* [-max ...]*] <database> <samples> <common_table>""",
    "one2all": """Counting common k-mers: single sample versus database:
    kmer-db-tpu one2all [-from-kmers | -from-minhash]
        <database> <sample> <common_table>""",
    "distance": """Calculating similarities/distances from a common-table:
    kmer-db-tpu distance <measure> [-sparse] [-phylip-out]
        [-min [<criterion>:]<value>]* [-max [<criterion>:]<value>]*
        <common_table> <output_table>
  measure: jaccard | min | max | cosine | mash | ani | ani-shorter""",
    "minhash": """Storing minhashed k-mers (.minhash next to each input):
    kmer-db-tpu minhash [-f <fraction>] [-k <kmer-length>]
        [-multisample-fasta] [-alphabet <type>] [-preserve-strand] <samples>
  default fraction: 0.01""",
}


def _usage(mode=None):
    if mode in _MODE_HELP:
        print(_MODE_HELP[mode], file=sys.stderr)
        print("\n<criterion>: num-kmers (default) or jaccard/min/max/cosine/"
              "mash/ani/ani-shorter.", file=sys.stderr)
        return
    print("USAGE\n    kmer-db-tpu <mode> [options] <positional arguments>\n",
          file=sys.stderr)
    print("Modes: " + ", ".join(MODES), file=sys.stderr)
    print("Run `kmer-db-tpu <mode> -help` for mode-specific options "
          "(option surface matches kmer-db 2.x).", file=sys.stderr)


class NotPortedError(RuntimeError):
    """A mode or setting of kmerdb_tpu that kmerdb_tpu_torch does not run yet."""

    def __init__(self, what: str):
        super().__init__(f"{what}: not yet ported to kmerdb_tpu_torch")


def _refuse_unported(p) -> None:
    if p.mode not in _RUNNERS:
        raise NotPortedError(f"mode {p.mode}")
    if p.from_fasta:
        raise NotPortedError(f"{p.mode} -from-fasta")
    if os.environ.get("KMERDB_COORD"):
        raise NotPortedError("KMERDB_COORD (the multi-process mesh)")
    mesh = p.mesh if p.mesh is not None else os.environ.get("KMERDB_MESH", "")
    if p.mode == "build" and mesh not in ("", "0", "1"):
        raise NotPortedError(f"build -mesh {mesh}")
    for var, value in _REFUSED_ENV.items():
        if os.environ.get(var) == value:
            raise NotPortedError(f"{var}={value}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        p = parse_args(argv)
        if p is None:
            return 0
        log.set_level(log.DEBUG if p.debug
                      else log.VERBOSE if p.verbose else log.NORMAL)
        _refuse_unported(p)
        runtime.configure(p.mesh)
        if p.num_threads:
            native.set_threads(p.num_threads)
        _RUNNERS[p.mode](p)
        return 0
    except UsageError as e:
        _usage(e.mode)
        return -1 & 0xFF
    except Exception as e:  # noqa: BLE001 — CLI boundary, as in kmerdb_tpu
        print(str(e), file=sys.stderr)
        return -1 & 0xFF


if __name__ == "__main__":
    sys.exit(main())
