"""The port's streamed all2all against kmerdb_tpu's and the host tier.

The stripe kernels' plain versions (kmerdb_tpu_torch/ops/gram.py) are held
to kmerdb_tpu's Pallas kernels run in the interpreter, on the same numpy
operands; the port's all2all_device_rows (device="cpu", the plain versions)
to kmerdb_tpu's all2all_device_rows (interpreted) and to the host C++ tier;
the CLI's streamed CSVs to kmerdb_tpu's and to the port's matrix route.
Counts are integers mod 2^32, so every comparison is exact.  The CUDA
kernels themselves are held to the plain versions on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerdb_tpu.cli.main import main as jax_main
from kmerdb_tpu.models import builder
from kmerdb_tpu.models.database import KmerPatternDb
from kmerdb_tpu.ops import device_a2a as jax_device_a2a
from kmerdb_tpu.ops import pallas_gram
from kmerdb_tpu.utils import native
from kmerdb_tpu_torch import _torchinit
from kmerdb_tpu_torch.cli import consoles
from kmerdb_tpu_torch.cli.main import main as port_main
from kmerdb_tpu_torch.ops import device_a2a, gram, intersect
from kmerdb_tpu_torch.utils import native as port_native

needs_native = pytest.mark.skipif(not native.available,
                                  reason="no native host runtime")


def _u32(rng, shape, hi=1 << 32):
    return rng.integers(0, hi, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy as the port's int32 storage (a copy)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)
                            .copy())


# (a) the stripe kernels' plain versions == kmerdb_tpu's interpreted kernels

@pytest.mark.parametrize("kt,tile,n_limbs,nrt,rt0", [
    (512, 128, 1, 2, 1), (512, 128, 5, 1, 3),
    (1024, 256, 1, 1, 1), (1024, 256, 5, 1, 2)])
def test_gram_pk_rows_matches_jax(kt, tile, n_limbs, nrt, rt0):
    """rt0 counts tiles of the caller's edge; distinct weights over every
    limb; a non-zero stripe accumulates."""
    rng = np.random.default_rng(kt + tile + n_limbs)
    S, rows = 4 * tile, 2 * kt
    B = (rng.random((rows, S)) < 0.2).astype(np.uint8)
    Bp = np.zeros((rows // 8, S), dtype=np.uint8)
    for i in range(rows):
        Bp[i >> 3] |= B[i] << np.uint8(i & 7)
    w = _u32(rng, rows, 1 << min(32, 7 * n_limbs))
    assert np.unique(w).size > 100            # no uniform weights
    wpk = pallas_gram.pk_weight_order(w, kt).reshape(-1, 1)
    C0 = _u32(rng, (nrt * tile, S))

    want = np.asarray(pallas_gram.gram_u32_pk_rows(
        jnp.asarray(Bp), jnp.asarray(wpk), jnp.asarray(C0), rt0,
        n_limbs=n_limbs, kt=kt, tile=tile, engine="s8"))
    Bt, wt, Ct = gram.from_jax_layout(Bp, wpk, C0, "cpu")
    got = gram.gram_u32_pk_rows(Bt, wt, Ct, rt0, n_limbs=n_limbs, kt=kt,
                                tile=tile)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert got is Ct and not np.array_equal(want, C0)
    # and the stripe is those rows of the whole Gram, plus C0
    r0 = rt0 * tile
    lhs = B[:, r0:r0 + nrt * tile].T.astype(np.uint64) * w.astype(np.uint64)
    np.testing.assert_array_equal(
        want, ((lhs @ B.astype(np.uint64) + C0) & 0xFFFFFFFF).astype(np.uint32))


def _edge_values(rng, shape):
    """Random uint32 cells, a third of them at the 16- and 32-bit edges."""
    edges = np.array([0, 1, (1 << 15) - 1, 1 << 15, (1 << 15) + 1,
                      (1 << 16) - 1, 1 << 16, (1 << 16) + 1, (1 << 31) - 1,
                      1 << 31, (1 << 31) + 1, (1 << 32) - 1], dtype=np.uint32)
    C = _u32(rng, shape)
    mask = rng.random(shape) < 1 / 3
    C[mask] = rng.choice(edges, size=int(mask.sum()))
    return C


def test_cast_rows_matches_jax():
    C = _edge_values(np.random.default_rng(1), (256, 384))
    want = np.asarray(pallas_gram.cast_rows(jnp.asarray(C), jnp.uint16))
    got = gram.cast_rows(_t(C))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)


@pytest.mark.parametrize("lo,hi", [
    (1, 0xFFFFFFFF), (50, 0xFFFFFFFF), (30, 200), (10**9, 0xFFFFFFFF),
    ((1 << 31) + 7, 0xFFFFFFFE), ((1 << 31) - 1, 1 << 31)])
def test_filter_colsum_matches_jax(lo, hi):
    """The bounds of tests/test_device_build.py's sparse pull, and two
    that only an unsigned compare gets right."""
    rng = np.random.default_rng(lo % 1000)
    C = _edge_values(rng, (384, 256))
    C[:128] %= 400                          # small counts, as in a stripe
    b = gram.bias_bounds(lo, hi)
    np.testing.assert_array_equal(b, pallas_gram.bias_bounds(lo, hi))
    want = np.asarray(pallas_gram.filter_colsum(jnp.asarray(C),
                                                jnp.asarray(b)))
    got = gram.filter_colsum(_t(C), b)
    assert got.dtype == torch.int32 and got.shape == (3, 256)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    keep = (C >= lo) & (C <= hi)
    np.testing.assert_array_equal(want, keep.reshape(3, 128, 256).sum(1))


@pytest.mark.parametrize("dtype,jdt,view", [
    (torch.int16, jnp.uint16, np.uint16), (torch.int32, jnp.uint32, np.uint32)])
def test_gather_tiles_matches_jax(dtype, jdt, view):
    """Repeated and unordered tiles of a rectangular stripe."""
    C = _edge_values(np.random.default_rng(2), (384, 512))
    i_tab = np.array([2, 0, 2, 1, 0, 2], dtype=np.int32)
    j_tab = np.array([3, 0, 3, 1, 2, 0], dtype=np.int32)
    want = np.asarray(pallas_gram.gather_tiles(
        jnp.asarray(C), i_tab, j_tab, dtype=jdt))
    got = gram.gather_tiles(_t(C), *gram.tile_tables(i_tab, j_tab, "cpu"),
                            dtype)
    assert got.dtype == dtype and got.shape == (6, 128, 128)
    np.testing.assert_array_equal(got.numpy().view(view), want)


def test_cpu_tensors_count_no_launch():
    rng = np.random.default_rng(4)
    C = _t(_u32(rng, (128, 256)))
    counters = (gram.gram_u32_pk_rows, gram.cast_rows, gram.filter_colsum,
                gram.gather_tiles)
    before = [f.launches for f in counters]
    Bt, wt, _ = gram.from_jax_layout(
        np.zeros((32, 256), np.uint8), np.zeros(256, np.uint32), C, "cpu")
    gram.gram_u32_pk_rows(Bt, wt, C, 1, n_limbs=1, kt=256)
    gram.cast_rows(C)
    gram.filter_colsum(C, gram.bias_bounds(0, 9))
    gram.gather_tiles(C, *gram.tile_tables([0], [1], "cpu"))
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("bad", [
    "rt0_past_end", "rt0_negative", "stripe_not_tiles", "stripe_width",
    "cast_dtype", "cast_shape", "bounds_dtype", "tables_dtype",
    "tile_outside", "pull_dtype"])
def test_stripe_wrappers_reject_bad_operands(bad):
    C = torch.zeros((256, 512), dtype=torch.int32)
    Bp = torch.zeros((32, 512), dtype=torch.uint8)
    w = torch.zeros(256, dtype=torch.int32)
    it, jt = gram.tile_tables([0], [0], "cpu")
    with pytest.raises(ValueError):
        if bad == "rt0_past_end":
            gram.gram_u32_pk_rows(Bp, w, C, 3, n_limbs=1, kt=256)
        elif bad == "rt0_negative":
            gram.gram_u32_pk_rows(Bp, w, C, -1, n_limbs=1, kt=256)
        elif bad == "stripe_not_tiles":
            gram.gram_u32_pk_rows(Bp, w, C[:200].contiguous(), 0, n_limbs=1,
                                  kt=256)
        elif bad == "stripe_width":
            gram.gram_u32_pk_rows(Bp, w, C[:, :384].contiguous(), 0,
                                  n_limbs=1, kt=256)
        elif bad == "cast_dtype":
            gram.cast_rows(C.to(torch.int64))
        elif bad == "cast_shape":
            gram.cast_rows(C[:, :300].contiguous())
        elif bad == "bounds_dtype":
            gram.filter_colsum(C, np.array([0, 9], dtype=np.int64))
        elif bad == "tables_dtype":
            gram.gather_tiles(C, it.long(), jt.long())
        elif bad == "tile_outside":
            gram.gather_tiles(C, *gram.tile_tables([2], [0], "cpu"))
        else:
            gram.gather_tiles(C, it, jt, torch.uint8)


# (b) all2all_device_rows: port == kmerdb_tpu == host C++ tier

def _host(db):
    return native.a2a_dense(db.pattern_offsets, db.pattern_sample_ids,
                            db.pattern_num_kmers, db.n_samples)


def _built(samples):
    return builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        samples)


def _db_ragged_200():
    """tests/test_device_build.py::test_streamed_rows_match_full_matrix."""
    rng = np.random.default_rng(31)
    return _built([(f"s{i}", np.unique(rng.integers(
        0, 1 << 36, size=int(rng.integers(300, 1500))).astype(np.uint64)))
        for i in range(200)])


def _db_sparse_150():
    """tests/test_device_build.py::test_streamed_sparse_pull_matches_filtered_dense."""
    rng = np.random.default_rng(37)
    return _built([(f"s{i}", np.unique(rng.integers(
        0, 1 << 20, size=int(rng.integers(300, 1500))).astype(np.uint64)))
        for i in range(150)])


def _db_ragged_heavy():
    """tests/test_odd_geometry.py::test_streamed_rows_ragged_heavy."""
    rng = np.random.default_rng(41)
    pool = rng.integers(0, 1 << 40, size=3000, dtype=np.uint64)
    core = np.unique(pool[:1500])
    samples = []
    for i in range(23):
        extra = np.unique(rng.choice(pool, size=rng.integers(50, 400),
                                     replace=False))
        samples.append((f"s{i}", np.unique(np.concatenate([core, extra]))))
    db = _built(samples)
    assert int(db.pattern_num_kmers.max()) >= 256   # multi-limb
    return db


def _db_wide_u32():
    """300 samples (an overlapping last stripe at 256-row stripes) with
    counts above 2^16 (the uint32 pull) and weights of 3 limbs."""
    rng = np.random.default_rng(5)
    S, P = 300, 500
    lens = rng.integers(1, 40, size=P)
    offs = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    sids = np.concatenate([np.sort(rng.choice(S, size=k, replace=False))
                           for k in lens]).astype(np.uint32)
    w = rng.integers(1, 300_000, size=P).astype(np.uint32)
    db = KmerPatternDb(kmer_length=18,
                       sample_names=[f"s{i}" for i in range(S)],
                       pattern_offsets=offs, pattern_sample_ids=sids,
                       pattern_num_kmers=w)
    db.sample_kmer_counts = np.diag(_host(db)).copy()
    assert db.sample_kmer_counts.max() >= 1 << 16
    return db


_DBS = {"ragged-200": (_db_ragged_200, 128),
        "ragged-heavy": (_db_ragged_heavy, 64),    # a sub-tile request
        "wide-u32": (_db_wide_u32, 256)}


def _rows(fn, db, **kw) -> np.ndarray:
    rows = []

    def handler(i, r):
        assert i == len(rows) and r.dtype == np.uint32 \
            and r.shape == (db.n_samples,)
        rows.append(r.copy())

    fn(db, handler, **kw)
    assert len(rows) == db.n_samples
    return np.stack(rows)


@needs_native
@pytest.mark.parametrize("resident_mb", ["4096", "0"],
                         ids=["resident", "repacked"])
@pytest.mark.parametrize("case", list(_DBS))
def test_streamed_rows_match_jax_and_host(case, resident_mb, monkeypatch):
    monkeypatch.setenv("KMERDB_A2A_RESIDENT_MB", resident_mb)
    make, stripe = _DBS[case]
    db = make()
    host = _host(db)
    got = _rows(device_a2a.all2all_device_rows, db, stripe_rows=stripe,
                device="cpu")
    np.testing.assert_array_equal(got, host)
    st = device_a2a.last_stats
    assert st["streamed"] and st["device"] == "cpu"
    assert st["resident_groups"] == (resident_mb != "0")
    assert st["stripe_rows"] == max(128, stripe // 128 * 128)
    np.testing.assert_array_equal(
        _rows(jax_device_a2a.all2all_device_rows, db, stripe_rows=stripe),
        host)


@needs_native
@pytest.mark.parametrize("lo,hi", [
    (1, 0xFFFFFFFF), (50, 0xFFFFFFFF), (30, 200), (10**9, 0xFFFFFFFF)])
def test_streamed_sparse_pull_matches_jax_and_host(lo, hi):
    db = _db_sparse_150()
    C = _host(db)
    want = np.where((C >= lo) & (C <= hi), C, 0)
    got = _rows(device_a2a.all2all_device_rows, db, stripe_rows=128,
                cell_bounds=(lo, hi), device="cpu")
    np.testing.assert_array_equal(got, want)
    sp = device_a2a.last_stats["sparse_pull"]
    assert sp["tiles_total"] == 2 * 2 and 0 <= sp["tiles_pulled"] <= 4
    np.testing.assert_array_equal(
        _rows(jax_device_a2a.all2all_device_rows, db, stripe_rows=128,
              cell_bounds=(lo, hi)), want)


@needs_native
def test_streamed_sparse_pull_selects_tiles_and_falls_back():
    """A selective bound pulls only the survivor tiles; a bound every
    tile passes takes the dense pull instead.  Counts above 2^16 go
    through the uint32 pull in both."""
    db = _db_wide_u32()
    C = _host(db)
    S = db.n_samples
    # the diagonal and the largest pair: at most 4 of a stripe's 6 tiles
    lo = int(C[np.tril_indices(S, -1)].max())
    for bounds, fallbacks in (((lo, 0xFFFFFFFF), 0), ((1, 0xFFFFFFFF), 2)):
        want = np.where((C >= bounds[0]) & (C <= bounds[1]), C, 0)
        got = _rows(device_a2a.all2all_device_rows, db, stripe_rows=256,
                    cell_bounds=bounds, device="cpu")
        np.testing.assert_array_equal(got, want)
        sp = device_a2a.last_stats["sparse_pull"]
        assert sp["dense_fallbacks"] == fallbacks
        assert sp["tiles_total"] == 2 * 6
        if fallbacks:
            assert sp["tiles_pulled"] == sp["tiles_total"]
        else:
            assert 0 < sp["tiles_pulled"] < sp["tiles_total"]


@needs_native
def test_default_stripe_is_128_mb_of_whole_tiles(monkeypatch):
    """STRIPE_BYTES / (S_pad * 4) rounded down to tiles, at least one
    tile; a 300-sample DB is one stripe."""
    db = _db_wide_u32()
    _rows(device_a2a.all2all_device_rows, db, device="cpu")
    assert device_a2a.last_stats["stripe_rows"] == 384
    monkeypatch.setattr(device_a2a, "STRIPE_BYTES", 384 * 4 * 200)
    _rows(device_a2a.all2all_device_rows, db, device="cpu")
    assert device_a2a.last_stats["stripe_rows"] == 128


# (c) the CLI's streamed route, byte for byte

@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    """tests/test_device_build.py::test_cli_sparse_stream_device_filter's
    corpus: 24 random 800 bp samples, k = 14."""
    d = tmp_path_factory.mktemp("torch_stream")
    rng = np.random.default_rng(43)
    paths = []
    for i in range(24):
        f = d / f"s{i}.fasta"
        f.write_text(f">s{i}\n{''.join(rng.choice(list('ACGT'), size=800))}\n")
        paths.append(str(f))
    (d / "samples.list").write_text("\n".join(paths) + "\n")
    assert port_main(["build", "-k", "14", str(d / "samples.list"),
                      str(d / "db")]) == 0
    return d, str(d / "db")


@needs_native
@pytest.mark.parametrize("opts", [[], ["-sparse", "-min", "2"]],
                         ids=["dense", "sparse"])
def test_cli_streamed_matches_jax_and_matrix_route(small_db, opts,
                                                   monkeypatch):
    d, db = small_db
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))
    outs = {}
    for name, main, env in (
            ("jax-stream", jax_main, {"KMERDB_A2A_STREAM": "1"}),
            ("port-stream", port_main, {"KMERDB_A2A_STREAM": "1"}),
            ("port-matrix", port_main, {"KMERDB_A2A_STREAM": "0",
                                        "KMERDB_A2A_DEVICE": "1"})):
        monkeypatch.delenv("KMERDB_A2A_DEVICE", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        device_a2a.last_stats.clear()
        out = d / f"{name}{len(opts)}.csv"
        assert main(["all2all", *opts, db, str(out)]) == 0
        outs[name] = out.read_bytes()
        if main is port_main:
            assert device_a2a.last_stats.get("streamed", False) == \
                (name == "port-stream")
            assert ("sparse_pull" in device_a2a.last_stats) == \
                (name == "port-stream" and bool(opts))
    assert outs["port-stream"] == outs["jax-stream"] == outs["port-matrix"]


# (d) the route's gate

@pytest.mark.parametrize("env,S,cuda,have_native,streams", [
    ("1", 10, False, True, True), ("0", 16385, True, True, False),
    ("", 16384, True, True, False), ("", 16385, True, True, True),
    ("", 16385, False, True, False), ("", 16385, True, False, False),
    ("1", 0, True, True, False)])
def test_stream_gate(env, S, cuda, have_native, streams, monkeypatch):
    monkeypatch.setenv("KMERDB_A2A_STREAM", env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(port_native, "available", have_native)
    db = KmerPatternDb(kmer_length=18,
                       sample_names=[f"s{i}" for i in range(S)])
    assert consoles._stream_rows(db) == streams


# (e) no second route behind a failed stream

@needs_native
def test_streamed_failure_exits_255_without_recompute(small_db, monkeypatch,
                                                      capsys):
    d, db = small_db
    recomputed = []

    def boom(*a, **kw):
        raise RuntimeError("stripe fault")

    monkeypatch.setenv("KMERDB_A2A_STREAM", "1")
    monkeypatch.setattr(device_a2a, "all2all_device_rows", boom)
    monkeypatch.setattr(intersect, "all2all_counts",
                        lambda *a: recomputed.append(1))
    assert port_main(["all2all", db, str(d / "failed.csv")]) == 255
    out, err = capsys.readouterr()
    assert "stripe fault" in err
    assert "WARNING" not in out + err and not recomputed


@needs_native
def test_forced_stream_without_cuda_raises(small_db, monkeypatch, capsys):
    d, db = small_db
    monkeypatch.setenv("KMERDB_A2A_STREAM", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_main(["all2all", db, str(d / "nocuda.csv")]) == 255
    assert "CUDA" in capsys.readouterr().err
