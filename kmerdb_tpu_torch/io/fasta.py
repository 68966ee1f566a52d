"""FASTA (.gz) ingest with the reference's exact splitting/naming rules.

Contract (reference src/genome_input_file.h, src/loader_ex.cpp):

* input path probing: try the path as given, then with appended
  extensions "", .fa, .fna, .fasta, .gz, .fa.gz, .fna.gz, .fasta.gz
  (genome_input_file.h:82-92).
* gzip is detected by content (magic bytes), not extension.
* contig split: every '>' byte starts a new record (strchr-based,
  genome_input_file.h:298-322); header runs to end-of-line, is
  \r-stripped and trimmed at the first space; newlines are removed
  from sequence bodies.
* sample naming: for file-per-sample inputs the sample name is the
  path's basename as listed (loader_ex.cpp:168); for multisample
  FASTA each contig is a sample named by its trimmed header
  (genome_input_file.h:261).
* a samples argument ending in a FASTA-ish extension is a single
  input file; anything else is a whitespace-separated list of paths
  (loader_ex.cpp:86-116).
"""

import gzip
import os

_PROBE_EXTENSIONS = ("", ".fa", ".fna", ".fasta",
                     ".gz", ".fa.gz", ".fna.gz", ".fasta.gz")

_LIST_DETECT_EXTENSIONS = (".fa", ".fna", ".fasta", ".fastq",
                           ".gz", ".fa.gz", ".fna.gz", ".fasta.gz", ".fastq.gz")


def resolve_input_path(path: str) -> str | None:
    """Extension probing per genome_input_file.h:82-92."""
    for ext in _PROBE_EXTENSIONS:
        cand = path + ext
        if os.path.exists(cand):
            return cand
    return None


def is_fasta_path(path: str) -> bool:
    """True if `path` names a FASTA file directly (vs. a list file)."""
    return any(path.endswith(ext) for ext in _LIST_DETECT_EXTENSIONS)


def read_file_list(path: str) -> list[str]:
    """Whitespace-separated sample paths (loader_ex.cpp:105-116)."""
    with open(path) as f:
        return f.read().split()


def read_raw(path: str) -> bytes:
    """Read a (possibly gzipped) file fully; gzip sniffed by magic.

    gz inflate rides libdeflate when present (io/inflate.py — the role
    of the reference's isa-l/zlib-ng fast path, file_wrapper.h:333,472)
    and falls back to stdlib zlib on any stream libdeflate rejects,
    matching the stdlib's tolerance envelope.
    """
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            from . import inflate
            if inflate.available():
                data = f.read()
                try:
                    return inflate.gzip_decompress(data)
                except ValueError:
                    import io as _io
                    with gzip.open(_io.BytesIO(data)) as gz:
                        return gz.read()
            with gzip.open(f) as gz:
                return gz.read()
        return f.read()


def split_contigs(data: bytes) -> tuple[list[bytes], list[bytes]]:
    """(headers, sequences) with the reference's strchr('>') splitting."""
    headers: list[bytes] = []
    seqs: list[bytes] = []
    chunks = data.split(b">")
    for chunk in chunks[1:]:
        nl = chunk.find(b"\n")
        if nl < 0:
            header, body = chunk, b""
        else:
            header, body = chunk[:nl], chunk[nl + 1:]
        header = header.rstrip(b"\r")
        sp = header.find(b" ")
        if sp >= 0:
            header = header[:sp]
        headers.append(header)
        seqs.append(body.replace(b"\n", b"").replace(b"\r", b""))
    return headers, seqs


def load_sample_contigs(path: str) -> list[bytes] | None:
    """Contig sequences of one (single-sample) FASTA file, or None if
    the file cannot be opened."""
    real = resolve_input_path(path)
    if real is None:
        return None
    _, seqs = split_contigs(read_raw(real))
    return seqs


def sample_name_from_path(path: str) -> str:
    return os.path.basename(path)
