"""The port's database load (kmerdb_tpu_torch/io/dbfile.py) on the CPU.

An encoded section is read through one reused window and each window
decoded on the host runtime's threads (csrc/host_load.cpp).  Held here:
the values equal the shared runtime's single-threaded decoders and the
NumPy fallback's at every window size and thread count, varints cut by
every window boundary, every varint width, empty and one-window sections,
truncated files and short or corrupt streams; load_db equals kmerdb_tpu's
in every mode for encoded, raw and .npz containers; and a fresh process
loading a large section rises in memory by its values and two windows,
not by its compressed bytes, counting its windows in load.windows.
"""

import io
import itertools
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from kmerdb_tpu.io import dbfile as jax_dbfile
from kmerdb_tpu.utils import native as jax_native
from kmerdb_tpu_torch.cli.main import main
from kmerdb_tpu_torch.io import dbfile
from kmerdb_tpu_torch.models.database import KmerPatternDb
from kmerdb_tpu_torch.utils import native, trace

REPO = pathlib.Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not native.available,
                                reason="no native host runtime")

#: (window, threads): windows of the smallest size, so that varints
#: straddle every boundary, up to one window for the whole section
WINDOWS = [(20, 1), (20, 4), (37, 3), (4096, 1), (4096, 8), (None, 1),
           (None, 8)]


def _decode(blob: np.ndarray, enc: str, n: int, window, threads,
            dtype=None):
    """(values, load.windows) of blob decoded by the windowed reader."""
    dtype = np.dtype(dtype or (np.uint64 if enc == "d64" else np.uint32))
    with trace.collect() as sums:
        out = dbfile._read_varints(io.BytesIO(blob.tobytes()), 0, blob.size,
                                   enc, dtype, n, "a section",
                                   window=window, threads=threads)
    return out, sums.counters.get("load.windows", 0)


def _today(blob: np.ndarray, enc: str, n: int) -> np.ndarray:
    """The shared runtime's single-threaded decoder, as the load read
    every encoded section before windows."""
    if enc == "d64":
        return jax_native.vb_decode_delta_u64(blob, n)
    return jax_native.vb_decode_u32(blob, n)


def _encode(enc: str, vals: np.ndarray) -> np.ndarray:
    if enc == "d64":
        return np.array(native.vb_encode_delta_u64(vals.astype(np.uint64)))
    return np.array(native.vb_encode_u32(vals.astype(np.uint32)))


def _check(enc: str, vals: np.ndarray, window, threads) -> int:
    """Decodes vals' encoding windowed and held to both references;
    returns load.windows."""
    blob = _encode(enc, vals)
    got, windows = _decode(blob, enc, vals.size, window, threads)
    assert got.dtype == vals.dtype
    assert np.array_equal(got, vals)
    assert np.array_equal(got, _today(blob, enc, vals.size))
    assert np.array_equal(
        got, dbfile._vb_decode_py(blob, vals.size, delta=enc == "d64")
        .astype(vals.dtype))
    return windows


def _widths(enc: str, n: int, seed: int) -> np.ndarray:
    """n values whose varints (deltas for d64) take every width: 1-5
    bytes for v32, 1-10 for d64, the widest deltas past 2^63."""
    rng = np.random.default_rng(seed)
    top, bits = (5, 32) if enc == "v32" else (10, 64)
    vals = []
    for w in rng.integers(1, top + 1, size=n).tolist():
        lo = 0 if w == 1 else 1 << 7 * (w - 1)
        hi = min(1 << 7 * w, 1 << bits) - 1
        vals.append(lo + int(rng.integers(0, 1 << 62)) % (hi - lo + 1))
    if enc == "d64":
        # the stream whose deltas these are, mod 2^64 as the decoder sums
        vals = [v % (1 << 64) for v in itertools.accumulate(vals)]
    return np.array(vals, dtype=np.uint32 if enc == "v32" else np.uint64)


def _sections(path) -> dict:
    """The section table of a database file's header."""
    with open(path, "rb") as f:
        f.seek(8)
        hlen = int.from_bytes(f.read(8), "little")
        return json.loads(f.read(hlen))["sections"]


@pytest.mark.parametrize("window,threads", WINDOWS)
@pytest.mark.parametrize("enc", ["v32", "d64"])
def test_roundtrip_equals_todays_decoder(enc, window, threads):
    rng = np.random.default_rng(11)
    n = 5_000
    if enc == "d64":
        vals = np.sort(rng.integers(0, 1 << 62, size=n, dtype=np.uint64))
    else:
        vals = rng.integers(0, 20_480, size=n, dtype=np.uint32)
    windows = _check(enc, vals, window, threads)
    nbytes = _encode(enc, vals).size
    if window is None:
        assert windows == 0
    else:
        # every window but the last reads window - carry bytes, the carry
        # under ten
        assert math.ceil(nbytes / window) <= windows \
            <= math.ceil(nbytes / (window - 9))


@pytest.mark.parametrize("window,threads", WINDOWS)
@pytest.mark.parametrize("enc", ["v32", "d64"])
def test_every_varint_width(enc, window, threads):
    vals = _widths(enc, 3_000, seed=5)
    blob = _encode(enc, vals)
    lens = np.diff(np.flatnonzero(blob < 0x80), prepend=-1)
    assert set(lens.tolist()) == set(range(1, (5 if enc == "v32" else 10)
                                            + 1))
    _check(enc, vals, window, threads)


@pytest.mark.parametrize("enc", ["v32", "d64"])
def test_empty_section(enc):
    dtype = np.uint64 if enc == "d64" else np.uint32
    for window, threads in WINDOWS:
        got, windows = _decode(np.empty(0, np.uint8), enc, 0, window,
                               threads)
        assert got.size == 0 and got.dtype == dtype and windows == 0


@pytest.mark.parametrize("enc", ["v32", "d64"])
def test_section_of_exactly_one_window(enc):
    """A section of one window's bytes decodes on one thread and counts no
    window; a byte more makes it two windows, on threads."""
    vals = np.arange(2_000, dtype=np.uint32) * 3 + 200   # two bytes each
    if enc == "d64":
        vals = vals.astype(np.uint64)
    nbytes = _encode(enc, vals).size
    assert _check(enc, vals, nbytes, 4) == 0
    assert _check(enc, vals, nbytes - 1, 4) == 2


@pytest.mark.parametrize("enc", ["v32", "d64"])
def test_thread_counts_agree(enc):
    vals = _widths(enc, 20_000, seed=9)
    blob = _encode(enc, vals)
    outs = [_decode(blob, enc, vals.size, 1 << 12, t)[0]
            for t in (1, 2, 3, 8, 64)]
    for o in outs[1:]:
        assert np.array_equal(o, outs[0])


def test_window_stops_at_the_last_whole_value():
    """The native window decode writes the values that end in its bytes and
    leaves a cut value's bytes for the next window; it writes at most
    out.size values, and refuses arrays of another layout."""
    vals = np.array([1, 300, 70_000, 5], dtype=np.uint32)
    blob = _encode("v32", vals)                       # 1 + 2 + 3 + 1 bytes
    out = np.zeros(4, np.uint32)
    state = np.zeros(1, np.uint64)
    for threads in (1, 3):
        assert native.vb_decode_window(blob[:5], out, state, threads) == (2, 3)
        assert native.vb_decode_window(blob, out[:3], state, threads) == (3, 6)
        assert out[:3].tolist() == [1, 300, 70_000]
    d = np.array([7, 9, 1 << 40], dtype=np.uint64)
    blob = _encode("d64", d)
    out = np.zeros(3, np.uint64)
    state[0] = 0
    assert native.vb_decode_window(blob[:2], out, state, 2) == (2, 2)
    assert state[0] == 9 and out[:2].tolist() == [7, 9]
    assert native.vb_decode_window(blob[2:], out[2:], state, 2) \
        == (1, blob.size - 2)
    assert out.tolist() == d.tolist() and state[0] == 1 << 40
    # pointers pass only for the layouts the C side reads and writes
    for bad in ((blob, out.view(np.int64), state),
                (blob.astype(np.int8), out, state),
                (blob, out[::2], state), (blob, out, state[:0])):
        with pytest.raises(ValueError):
            native.vb_decode_window(*bad, 1)


@pytest.mark.parametrize("enc", ["v32", "d64"])
@pytest.mark.parametrize("window,threads", [(20, 1), (64, 4), (None, 1)])
def test_short_and_corrupt_streams_raise(enc, window, threads):
    vals = _widths(enc, 500, seed=3)
    blob = _encode(enc, vals)
    # fewer values than the section claims, or its last value cut short
    with pytest.raises(IOError, match="Corrupt k-mer database"):
        _decode(blob, enc, vals.size + 1, window, threads)
    cut = blob.copy()
    cut[-1] |= 0x80
    with pytest.raises(IOError, match="Corrupt k-mer database"):
        _decode(cut, enc, vals.size, window, threads)
    # a value of more than ten bytes
    bad = np.concatenate([blob[:7], np.full(11, 0x81, np.uint8), blob[7:]])
    with pytest.raises(IOError, match="Corrupt k-mer database"):
        _decode(bad, enc, vals.size, window, threads)


def test_truncated_file_raises(tmp_path, monkeypatch):
    """A file cut inside an encoded section keeps the load's message, in
    one window or in many."""
    n = 40_000
    d = KmerPatternDb(kmer_length=18, sample_names=["a", "b"],
                      sample_kmer_counts=np.array([5, 3], np.uint32),
                      pattern_offsets=np.array([0, n // 2, n], np.int64),
                      pattern_sample_ids=np.arange(n, dtype=np.uint32) % 2,
                      pattern_num_kmers=np.array([2, 1], np.uint32))
    path = tmp_path / "db"
    dbfile.save_db(d, str(path))
    path.write_bytes(path.read_bytes()[:-5_000])
    for window in (dbfile.WINDOW, 4096):
        monkeypatch.setattr(dbfile, "WINDOW", window)
        with pytest.raises(IOError, match="Truncated k-mer database .*: "
                           "section pattern_sample_ids has 3[0-9]{4}/40000 "
                           "bytes"):
            dbfile.load_db(str(path), dbfile.PATTERNS)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A database of 60 random 2 kbp samples built by the port, k 16."""
    d = tmp_path_factory.mktemp("torch_dbfile")
    rng = np.random.default_rng(23)
    paths = []
    for i in range(60):
        f = d / f"s{i}.fasta"
        f.write_text(f">s{i}\n{''.join(rng.choice(list('ACGT'), 2000))}\n")
        paths.append(str(f))
    (d / "samples.list").write_text("\n".join(paths) + "\n")
    assert main(["build", "-t", "2", "-k", "16", str(d / "samples.list"),
                 str(d / "db")]) == 0
    return d / "db"


FIELDS = ("sample_kmer_counts", "pattern_offsets", "pattern_sample_ids",
          "pattern_num_kmers", "kmers", "kmer_pattern_ids")
MODES = (dbfile.SAMPLES_ONLY, dbfile.PATTERNS, dbfile.EVERYTHING)


def _same_as_kmerdb_tpu(path, mode):
    got, want = dbfile.load_db(str(path), mode), jax_dbfile.load_db(
        str(path), mode)
    assert (got.kmer_length, got.fraction, got.start_fraction,
            got.alphabet_name, got.sample_names) == (
        want.kmer_length, want.fraction, want.start_fraction,
        want.alphabet_name, want.sample_names)
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    return got


@pytest.mark.parametrize("window", [64, 1 << 12, None])
@pytest.mark.parametrize("mode", MODES)
def test_load_db_equals_kmerdb_tpu(built, mode, window, monkeypatch):
    if window:
        monkeypatch.setattr(dbfile, "WINDOW", window)
    with trace.collect() as sums:
        got = _same_as_kmerdb_tpu(built, mode)
    sec = _sections(built)
    loaded = ("sample_kmer_counts", *dbfile._MODE_SECTIONS[mode])
    assert (sums.counters.get("load.windows", 0) > 0) == any(
        sec[k]["enc"] != "raw" and sec[k]["nbytes"] > dbfile.WINDOW
        for k in loaded)
    if mode == dbfile.EVERYTHING:
        assert got.kmers.size and got.kmer_pattern_ids.size


@pytest.mark.parametrize("mode", MODES)
def test_raw_and_npz_containers_equal_kmerdb_tpu(built, mode, tmp_path,
                                                 monkeypatch):
    """Raw sections (a database saved without the runtime's codecs) and
    the earlier .npz container load as kmerdb_tpu loads them."""
    d = dbfile.load_db(str(built), dbfile.EVERYTHING)
    with monkeypatch.context() as m:
        m.setattr(native, "available", False)
        dbfile.save_db(d, str(tmp_path / "raw"))
    hdr = (tmp_path / "raw").read_bytes()
    assert b'"enc": "v32"' not in hdr and b'"enc": "raw"' in hdr
    _same_as_kmerdb_tpu(tmp_path / "raw", mode)
    meta = {"magic": "kmerdb_tpu-db-v1", "kmer_length": d.kmer_length,
            "fraction": d.fraction, "start_fraction": d.start_fraction,
            "alphabet": d.alphabet_name}
    with open(tmp_path / "npz", "wb") as f:
        np.savez(f, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                 sample_names=np.frombuffer("\n".join(d.sample_names)
                                            .encode(), np.uint8),
                 **{k: getattr(d, k) for k in FIELDS})
    _same_as_kmerdb_tpu(tmp_path / "npz", mode)


#: the memory test's section: 2-byte varints, so no value is cut by a
#: window and the section needs ceil(nbytes / WINDOW) windows
MEM_VALUES = 32 << 20
MEM_WINDOW = 4 << 20

_WRITE = """
import sys
import numpy as np
from kmerdb_tpu_torch.io import dbfile
from kmerdb_tpu_torch.models.database import KmerPatternDb
n = int(sys.argv[2])
sids = np.arange(n, dtype=np.uint32)
sids %= 16000
sids += 128
P = 64
d = KmerPatternDb(kmer_length=18, sample_names=[f"s{i}" for i in range(16128)],
                  sample_kmer_counts=np.ones(16128, np.uint32),
                  pattern_offsets=np.linspace(0, n, P + 1).astype(np.int64),
                  pattern_sample_ids=sids,
                  pattern_num_kmers=np.ones(P, np.uint32))
dbfile.save_db(d, sys.argv[1])
"""

_LOAD = """
import json, resource, sys
from kmerdb_tpu_torch.io import dbfile
from kmerdb_tpu_torch.utils import trace
def rss():
    with open("/proc/self/status") as f:
        return next(int(l.split()[1]) for l in f if l.startswith("VmRSS:"))
dbfile.WINDOW = int(sys.argv[2])
before = rss()
with trace.collect() as sums:
    d = dbfile.load_db(sys.argv[1], dbfile.PATTERNS)
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(json.dumps({"rise_kib": peak - before, "windows":
                  sums.counters.get("load.windows", 0),
                  "values": int(d.pattern_sample_ids.size),
                  "decoded": int(d.pattern_sample_ids.nbytes)}))
"""


#: runs its arguments as a child: exec carries the RSS of the process that
#: forked into the new image's ru_maxrss, so the measured process is
#: forked from this small one and not from the test process
_LAUNCH = "import subprocess, sys; sys.exit(subprocess.call(sys.argv[1:]))"


def _fresh(code: str, *args) -> str:
    r = subprocess.run([sys.executable, "-c", _LAUNCH, sys.executable, "-c",
                        code, *map(str, args)],
                       cwd=REPO, capture_output=True, text=True, timeout=600,
                       env={"PATH": os.environ.get("PATH", ""),
                            "PYTHONPATH": str(REPO), "KMERDB_THREADS": "4"})
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_load_memory_is_the_values_and_two_windows(tmp_path, built):
    """A fresh process loads a database whose pattern_sample_ids section
    is 64 MiB compressed (128 MiB of values) through 4 MiB windows: its
    peak rises by the values, two windows and a small margin, not by the
    compressed copy; load.windows counts the section's windows.  The small
    built database counts none."""
    path = tmp_path / "big"
    _fresh(_WRITE, path, MEM_VALUES)
    sec = _sections(path)
    nbytes = sec["pattern_sample_ids"]["nbytes"]
    assert nbytes == 2 * MEM_VALUES and sec["pattern_sample_ids"]["enc"] \
        == "v32"
    got = json.loads(_fresh(_LOAD, path, MEM_WINDOW))
    assert got["values"] == MEM_VALUES
    margin = 16 << 20
    assert got["rise_kib"] * 1024 < \
        got["decoded"] + 2 * MEM_WINDOW + margin, got
    assert got["windows"] == math.ceil(nbytes / MEM_WINDOW)
    small = json.loads(_fresh(_LOAD, built, MEM_WINDOW))
    assert small["windows"] == 0
