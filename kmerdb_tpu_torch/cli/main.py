"""Entry point: `python -m kmerdb_tpu_torch <mode> [options] <args>`.

The options and exit codes are kmerdb_tpu's (kmerdb_tpu/cli/main.py):
exit 0 on success, 255 on any error.  ``build``, ``minhash``,
``distance`` and ``one2all`` run on the host and go to kmerdb_tpu's
runners unchanged; ``all2all`` over a database, ``new2all`` and
``all2all-parts`` run the port's tier choices (cli/consoles.py,
cli/parts.py).  Modes and settings that would reach JAX code in
kmerdb_tpu, or that the port has no device tier for yet, are refused with
an error rather than run on some other route.
"""

import os
import sys

from ..host import cli_main, consoles as host_consoles, log, native, params
from . import consoles, parts

_RUNNERS = {
    "build": host_consoles.run_build,
    "minhash": host_consoles.run_minhash,
    "distance": host_consoles.run_distance,
    "one2all": host_consoles.run_one2all,
    "all2all": consoles.run_all2all,
    "new2all": consoles.run_new2all,
    "all2all-parts": parts.run_all2all_parts,
}

#: settings that route kmerdb_tpu's shared runners into its JAX code
_REFUSED_ENV = {
    "KMERDB_BUILD_DEVICE": "1",
    "KMERDB_DEVICE_INGEST": "1",
    "KMERDB_A2A_ENGINE": "bf16",
}


class NotPortedError(RuntimeError):
    """A mode or setting of kmerdb_tpu that kmerdb_tpu_torch does not run yet."""

    def __init__(self, what: str):
        super().__init__(f"{what}: not yet ported to kmerdb_tpu_torch")


def _refuse_unported(p) -> None:
    if p.mode not in _RUNNERS:
        raise NotPortedError(f"mode {p.mode}")
    if p.mode == "all2all" and p.from_fasta:
        raise NotPortedError("all2all -from-fasta")
    mesh = p.mesh if p.mesh is not None else os.environ.get("KMERDB_MESH", "")
    if mesh not in ("", "0", "1"):
        raise NotPortedError(f"-mesh {mesh}")
    for var, value in _REFUSED_ENV.items():
        if os.environ.get(var) == value:
            raise NotPortedError(f"{var}={value}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        p = params.parse_args(argv)
        if p is None:
            return 0
        log.set_level(log.DEBUG if p.debug
                      else log.VERBOSE if p.verbose else log.NORMAL)
        _refuse_unported(p)
        if p.num_threads:
            native.set_threads(p.num_threads)
        _RUNNERS[p.mode](p)
        return 0
    except params.UsageError as e:
        cli_main._usage(e.mode)
        return -1 & 0xFF
    except Exception as e:  # noqa: BLE001 — CLI boundary, as in kmerdb_tpu
        print(str(e), file=sys.stderr)
        return -1 & 0xFF


if __name__ == "__main__":
    sys.exit(main())
