"""The port's device mesh against kmerdb_tpu's and the single-card tiers.

kmerdb_tpu runs its sharded kernels on the 8 virtual CPU devices that
tests/conftest.py sets up; the port's mesh is built here of CPU slots
(``_torchinit.devices`` patched), so each slot's share goes through the
kernels' plain versions.  Both sides get the same numpy database.  Counts
are integers mod 2^32: every comparison is exact, and CSVs are compared
byte for byte.  The CUDA kernels themselves, and a mesh of CUDA streams,
are held to the same results on a card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerdb_tpu.cli.main import main as jax_main
from kmerdb_tpu.ops import intersect as jax_intersect
from kmerdb_tpu.ops import pallas_gram
from kmerdb_tpu.parallel import mesh as jax_mesh
from kmerdb_tpu.parallel import runtime as jax_runtime
from kmerdb_tpu.parallel import sharded as jax_sharded
from kmerdb_tpu.utils import bench_corpus, native
from kmerdb_tpu_torch import _torchinit
from kmerdb_tpu_torch.cli.main import main as port_main
from kmerdb_tpu_torch.ops import device_a2a, gram, intersect
from kmerdb_tpu_torch.parallel import runtime, sharded
from kmerdb_tpu_torch.parallel.mesh import Mesh, make_mesh

from test_a2a_paths import _random_db
from test_torch_parts import _disjoint_db, _parts_dbs
from test_torch_query import _case
from test_torch_stream import (_db_ragged_heavy, _db_sparse_150,
                               _db_wide_u32, _host, _rows, _t, _u32)

needs_native = pytest.mark.skipif(not native.available,
                                  reason="no native host runtime")
U32_MAX = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def cpu_slots(monkeypatch):
    """Eight CPU slots for make_mesh (the counterpart of conftest's 8
    virtual devices), a CPU "card" for the single-card tiers, and no mesh
    request left behind in either package."""
    monkeypatch.setattr(_torchinit, "devices",
                        lambda: [torch.device("cpu")] * 8)
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))
    yield
    runtime.configure(None)
    jax_runtime.configure(None)


# (a) bounds_zero_rows' plain version == kmerdb_tpu's interpreted kernel

@pytest.mark.parametrize("dtype,jdt,view", [
    (torch.int16, jnp.uint16, np.uint16), (torch.int32, jnp.uint32, np.uint32)],
    ids=["u16", "u32"])
@pytest.mark.parametrize("lo,hi", [
    (1, U32_MAX), (50, U32_MAX), (30, 200), (65_536, 1 << 31),
    ((1 << 31) - 5, (1 << 31) + 5), ((1 << 31) + 7, U32_MAX - 1)])
def test_bounds_zero_rows_matches_jax(lo, hi, dtype, jdt, view):
    """Cells at the bounds, at the 16- and 32-bit edges and on both sides of
    2^31, where a signed compare of the int32 storage would go wrong; a
    surviving cell >= 65,536 leaves its low 16 bits in the uint16 output."""
    rng = np.random.default_rng(lo % 997)
    edges = np.array([0, lo - 1, lo, hi, min(hi + 1, U32_MAX), 65_535, 65_536,
                      (1 << 31) - 1, 1 << 31, U32_MAX], dtype=np.uint32)
    C = _u32(rng, (256, 384))
    C[:128] %= 400                           # small counts, as in a stripe
    mask = rng.random(C.shape) < 1 / 3
    C[mask] = rng.choice(edges, size=int(mask.sum()))
    C[0, :edges.size] = edges                # every edge at least once
    b = gram.bias_bounds(lo, hi)
    want = np.asarray(pallas_gram.bounds_zero_rows(
        jnp.asarray(C), jnp.asarray(b), dtype=jdt, interpret=True))
    for fn in (gram.bounds_zero_rows, gram.bounds_zero_rows_plain):
        got = fn(_t(C), b, dtype)
        assert got.dtype == dtype and got.shape == C.shape
        np.testing.assert_array_equal(got.numpy().view(view), want)
    keep = (C >= lo) & (C <= hi)
    np.testing.assert_array_equal(want, np.where(keep, C, 0).astype(view))
    assert keep.any() and not keep.all()


def test_bounds_zero_rows_counts_no_launch_and_rejects_bad_operands():
    C = torch.zeros((128, 256), dtype=torch.int32)
    before = gram.bounds_zero_rows.launches
    gram.bounds_zero_rows(C, gram.bias_bounds(1, 9))
    assert gram.bounds_zero_rows.launches == before
    for bad in (lambda: gram.bounds_zero_rows(C, np.array([0, 9], np.int64)),
                lambda: gram.bounds_zero_rows(C, gram.bias_bounds(1, 9),
                                              torch.uint8),
                lambda: gram.bounds_zero_rows(C[:, :200].contiguous(),
                                              gram.bias_bounds(1, 9)),
                lambda: gram.bounds_zero_rows(C.long(),
                                              gram.bias_bounds(1, 9))):
        with pytest.raises(ValueError):
            bad()


# (b) the mesh itself

def test_make_mesh_takes_the_first_devices_and_refuses_more():
    assert make_mesh().size == 8 and make_mesh(3).size == 3
    assert make_mesh(3).devices == [torch.device("cpu")]
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        make_mesh(9)
    with pytest.raises(ValueError):
        Mesh([])


def test_mesh_run_visits_slots_in_order():
    m = Mesh(["cpu"] * 5)
    assert m.run(lambda i, slot: (i, slot.device.type, slot.stream)) == \
        [(i, "cpu", None) for i in range(5)]


def test_devices_needs_a_card(monkeypatch):
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _torchinit.devices()


@pytest.mark.parametrize("request_,env,size", [
    (None, "", None), ("0", "8", None), ("1", "8", None), (None, "1", None),
    ("3", "", 3), (None, "5", 5), ("auto", "", 8), ("2", "7", 2)])
def test_runtime_resolves_the_request(request_, env, size, monkeypatch):
    """kmerdb_tpu's rules: the CLI value before KMERDB_MESH; "", "0", "1"
    mean no mesh; auto takes every device."""
    monkeypatch.setenv("KMERDB_MESH", env)
    for rt in (runtime, jax_runtime):
        rt.configure(request_)
        m = rt.active_mesh()
        assert (m if size is None else
                getattr(m, "size", None) or m.devices.size) == size
        assert rt.active_mesh() is m


def test_runtime_one_slot_is_no_mesh(monkeypatch):
    monkeypatch.setattr(_torchinit, "devices", lambda: [torch.device("cpu")])
    runtime.configure("auto")
    assert runtime.active_mesh() is None


# (c) all2all_rows_sharded: port == kmerdb_tpu on the same mesh size ==
#     the port's single-card streamed route == the host tier

_ROW_DBS = {"wide-u32": _db_wide_u32, "ragged-heavy": _db_ragged_heavy,
            "sparse-150": _db_sparse_150}


def _bounded(C, cell_bounds):
    if cell_bounds is None:
        return C
    return np.where((C >= cell_bounds[0]) & (C <= cell_bounds[1]), C, 0)


@needs_native
@pytest.mark.parametrize("cell_bounds", [None, (30, U32_MAX)],
                         ids=["dense", "bounds"])
@pytest.mark.parametrize("stripe_rows", [None, 128])
@pytest.mark.parametrize("D", [2, 3, 8])
def test_rows_sharded_match_jax_single_card_and_host(D, stripe_rows,
                                                     cell_bounds):
    """300 samples are 3 tiles: at 128-row stripes 2 slots take two rounds,
    the second clamped onto the last tile, and 8 slots one round in which
    six stripes repeat it; counts above 2^16 take the uint32 pull."""
    db = _db_wide_u32()
    want = _bounded(_host(db), cell_bounds)
    kw = dict(stripe_rows=stripe_rows, cell_bounds=cell_bounds)
    got = _rows(lambda db, h, **kw: sharded.all2all_rows_sharded(
        db, make_mesh(D), h, **kw), db, **kw)
    np.testing.assert_array_equal(got, want)
    st = sharded.last_stats
    assert st["slots"] == D and st["devices"] == 1 and not st["narrow"]
    assert st["stripe_rows"] == (384 if stripe_rows is None else 128)
    assert st["rounds"] == (2 if (D, stripe_rows) == (2, 128) else 1)
    np.testing.assert_array_equal(
        _rows(lambda db, h, **kw: jax_sharded.all2all_rows_sharded(
            db, jax_mesh.make_mesh(D), h, **kw), db, **kw), want)
    np.testing.assert_array_equal(
        _rows(device_a2a.all2all_device_rows, db, device="cpu", **kw), want)


@needs_native
@pytest.mark.parametrize("resident_mb", ["4096", "0"],
                         ids=["resident", "repacked"])
@pytest.mark.parametrize("case,cell_bounds", [
    ("ragged-heavy", None), ("sparse-150", (50, U32_MAX)),
    ("sparse-150", (30, 200)), ("wide-u32", (1, U32_MAX))])
def test_rows_sharded_resident_and_repacked(case, cell_bounds, resident_mb,
                                            monkeypatch):
    """The uint16 pull (cast_rows, or bounds_zero_rows narrowing), heavy
    multi-limb groups and a sample count off the tile; groups resident on
    the device and re-packed every round."""
    monkeypatch.setenv("KMERDB_A2A_RESIDENT_MB", resident_mb)
    db = _ROW_DBS[case]()
    want = _bounded(_host(db), cell_bounds)
    kw = dict(stripe_rows=128, cell_bounds=cell_bounds)
    got = _rows(lambda db, h, **kw: sharded.all2all_rows_sharded(
        db, make_mesh(3), h, **kw), db, **kw)
    np.testing.assert_array_equal(got, want)
    st = sharded.last_stats
    assert st["resident_groups"] == (resident_mb != "0")
    assert st["narrow"] == (case != "wide-u32")
    np.testing.assert_array_equal(
        _rows(lambda db, h, **kw: jax_sharded.all2all_rows_sharded(
            db, jax_mesh.make_mesh(3), h, **kw), db, **kw), want)


@needs_native
@pytest.mark.parametrize("D,stripe_rows,rounds", [(2, 256, 2), (4, 128, 2),
                                                  (3, 256, 1), (5, 128, 2)])
def test_rows_sharded_clamped_tail_round(D, stripe_rows, rounds):
    """700 samples are 6 tiles: the last round's stripes are clamped
    backwards, and each row is still handed out once, in order (_rows
    asserts it)."""
    db = _random_db(np.random.default_rng(7), 700, 300, max_len=60)
    db.sample_kmer_counts = np.diag(_host(db)).copy()
    got = _rows(lambda db, h: sharded.all2all_rows_sharded(
        db, make_mesh(D), h, stripe_rows=stripe_rows), db)
    np.testing.assert_array_equal(got, _host(db))
    assert sharded.last_stats["rounds"] == rounds


def test_rows_sharded_empty_database():
    db = _random_db(np.random.default_rng(0), 5, 3)
    db.sample_names = []
    sharded.all2all_rows_sharded(db, make_mesh(2), lambda *a: 1 / 0)


# (d) the sharded count paths

@needs_native
@pytest.mark.parametrize("D", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ["heavy", "wraparound", "built"])
def test_all2all_counts_sharded_matches_jax_and_single_card(case, D,
                                                            monkeypatch):
    """Weights past one 8-bit limb and past 2^16, and counts that wrap
    mod 2^32; 8 slots over fewer chunks than slots leave some empty."""
    if case == "built":
        db = _db_ragged_heavy()
    else:
        db = _random_db(np.random.default_rng(3), 70, 37 if D == 8 else 500,
                        max_w=U32_MAX if case == "wraparound" else 300_000)
    monkeypatch.setattr(intersect, "_CHUNK_E", 512)   # several chunks a slot
    host = _host(db)
    if case == "wraparound":
        assert (np.diag(host).astype(np.uint64) <
                db.pattern_num_kmers.sum(dtype=np.uint64)).any()
    intersect.scan_stats.clear()
    got = sharded.all2all_counts_sharded(db, Mesh(["cpu"] * D))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, host)
    assert intersect.scan_stats["chunks"] >= min(D, db.n_patterns)
    np.testing.assert_array_equal(
        jax_sharded.all2all_counts_sharded(db, jax_mesh.make_mesh(D)), host)
    np.testing.assert_array_equal(intersect._a2a_scan(db), host)


def test_all2all_counts_sharded_empty():
    db = _random_db(np.random.default_rng(0), 5, 3)
    db.pattern_offsets = db.pattern_offsets[:1]
    db.pattern_num_kmers = db.pattern_num_kmers[:0]
    assert not sharded.all2all_counts_sharded(db, make_mesh(2)).any()


@needs_native
@pytest.mark.parametrize("D", [1, 2, 3, 8])
@pytest.mark.parametrize("name", ["u8", "u32", "empty-and-no-hit",
                                  "chunked-130"])
def test_many2all_counts_sharded_matches_jax_and_single_card(name, D,
                                                             monkeypatch):
    db, queries, _ = _case(name)
    if name == "chunked-130":
        monkeypatch.setattr(jax_intersect, "_CHUNK_E", 64)
        monkeypatch.setattr(intersect, "_CHUNK_E", 64)
    host = jax_intersect.many2all_counts(db, queries, use_device=False)
    got = sharded.many2all_counts_sharded(db, queries, Mesh(["cpu"] * D))
    assert got.dtype == np.uint32 and got.shape == host.shape
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(jax_sharded.many2all_counts_sharded(
        db, queries, jax_mesh.make_mesh(D)), host)
    monkeypatch.setenv("KMERDB_N2A_DEVICE", "1")
    np.testing.assert_array_equal(intersect.many2all_counts(db, queries),
                                  host)


def test_many2all_counts_sharded_pads_queries_to_whole_blocks_a_slot():
    db, queries, _ = _case("u8")
    H_all, _, _ = intersect.m2a_prepare(db, queries, q_align=3 * 128)
    assert H_all.shape[1] == 384
    assert intersect.m2a_prepare(db, queries)[0].shape[1] == 128
    assert sharded.many2all_counts_sharded(db, [], make_mesh(2)).shape == \
        (0, db.n_samples)


@needs_native
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_db2db_counts_sharded_matches_jax_and_single_card(D, monkeypatch):
    """A pattern pair sharing 17,000 k-mers (three 7-bit limbs); databases
    that share nothing give zeros without touching a device."""
    rng = np.random.default_rng(6)
    a, b = _parts_dbs(rng, [5, 7], pool_size=20_000, core_size=17_000)
    c = _disjoint_db(rng)
    mesh = Mesh(["cpu"] * D)
    monkeypatch.setenv("KMERDB_D2D_DEVICE", "1")
    for row, col in ((a, b), (b, a)):
        host = jax_intersect.db2db_counts(row, col)
        got = sharded.db2db_counts_sharded(row, col, mesh)
        assert got.dtype == np.uint32 and int(host.max()) >= 1 << 14
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(jax_sharded.db2db_counts_sharded(
            row, col, jax_mesh.make_mesh(D)), host)
        np.testing.assert_array_equal(intersect.db2db_counts(row, col), host)
    assert not sharded.db2db_counts_sharded(a, c, mesh).any()


@needs_native
def test_db2db_counts_sharded_more_slots_than_pairs():
    rng = np.random.default_rng(8)
    a, b = _parts_dbs(rng, [2, 2], pool_size=600, core_size=500)
    assert 0 < intersect.d2d_pairs(a, b)[0].size < 16
    np.testing.assert_array_equal(
        sharded.db2db_counts_sharded(a, b, Mesh(["cpu"] * 16)),
        jax_intersect.db2db_counts(a, b))


@needs_native
def test_plan_stats_hold_the_launches_the_plans_come_to(monkeypatch):
    """plan_stats adds up, call by call, what each slot is given: the
    chunks of new2all's operands, db2db's non-empty pair shares and their
    chunks of pairs (one launch each on a card)."""
    rng = np.random.default_rng(8)
    a, b = _parts_dbs(rng, [2, 2], pool_size=600, core_size=500)
    n_pairs = intersect.d2d_pairs(a, b)[0].size
    db, queries, _ = _case("chunked-130")
    monkeypatch.setattr(intersect, "_CHUNK_E", 64)
    n_chunks = intersect.m2a_prepare(db, queries)[0].shape[0]
    assert n_chunks > 1
    sharded.plan_stats.clear()
    for D in (3, 16):
        sharded.db2db_counts_sharded(a, b, Mesh(["cpu"] * D))
        sharded.many2all_counts_sharded(db, queries, Mesh(["cpu"] * D))
    shares = sum(-(-n_pairs // -(-n_pairs // D)) for D in (3, 16))
    assert sharded.plan_stats == dict(
        m2a_calls=2, m2a_chunks=2 * n_chunks, d2d_calls=2, d2d_shares=shares,
        d2d_launches=shares)
    monkeypatch.setattr(intersect, "_CHUNK", 16)     # 128 pairs a chunk
    assert [intersect._d2d_chunk_rows(n) for n in (0, 1, 128, 129, 10**6)] \
        == [128, 128, 128, 128, 128]
    monkeypatch.undo()
    assert [intersect._d2d_chunk_rows(n) for n in (0, 1, 256, 257)] \
        == [intersect.KT] * 3 + [2 * intersect.KT]


# (e) the CLI under -mesh and KMERDB_MESH, byte for byte

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """21 samples, 6 queries and 3 parts of 7, built by both packages."""
    if not native.available:
        pytest.skip("no native host runtime")
    d = tmp_path_factory.mktemp("torch_mesh")
    lst = bench_corpus.generate(str(d / "corpus"), n_samples=21,
                                genome_len=3000)
    samples = [s for s in pathlib.Path(lst).read_text().split() if s]
    (d / "queries.list").write_text("\n".join(samples[3:9]) + "\n")
    assert port_main(["build", "-k", "16", lst, str(d / "db")]) == 0
    parts = []
    for i in range(3):
        (d / f"part{i}.list").write_text(
            "\n".join(samples[7 * i:7 * i + 7]) + "\n")
        parts.append(str(d / f"part{i}.db"))
        assert port_main(["build", "-k", "16", str(d / f"part{i}.list"),
                          parts[-1]]) == 0
    (d / "parts.list").write_text("\n".join(parts) + "\n")
    return d


_MODES = {
    "all2all": ["all2all", "{d}/db"],
    "all2all-sparse": ["all2all", "-sparse", "-min", "jaccard:0.02", "{d}/db"],
    "all2all-sp": ["all2all-sp", "-min", "2", "{d}/db"],
    "all2all-sp-sample-rows": ["all2all-sp", "-sample-rows", "3", "{d}/db"],
    "all2all-sp-sample-best": ["all2all-sp", "-sample-rows", "jaccard:2",
                               "{d}/db"],
    "new2all": ["new2all", "{d}/db", "{d}/queries.list"],
    "new2all-sparse": ["new2all", "-sparse", "-min", "3", "{d}/db",
                       "{d}/queries.list"],
    "all2all-parts": ["all2all-parts", "{d}/parts.list"],
    "all2all-parts-sample-rows": ["all2all-parts", "-sample-rows", "2",
                                  "{d}/parts.list"],
}

#: the sharded functions each mode's matrix route runs under a mesh
_SHARDED = {
    "all2all": {"all2all_counts_sharded"},
    "all2all-sp": {"all2all_counts_sharded"},
    "new2all": {"many2all_counts_sharded"},
    "all2all-parts": {"all2all_counts_sharded", "db2db_counts_sharded"},
}


def _cli(main, d, mode, out, extra=()) -> bytes:
    argv = [a.format(d=d) for a in _MODES[mode]] + [str(d / out), *extra]
    assert main(argv) == 0, argv
    return (d / out).read_bytes()


def _no_device_tiers(monkeypatch):
    for var in ("KMERDB_A2A_DEVICE", "KMERDB_N2A_DEVICE", "KMERDB_D2D_DEVICE",
                "KMERDB_GRID_DEVICE"):
        monkeypatch.setenv(var, "0")


@pytest.mark.parametrize("n_dev", ["3", "8"])
@pytest.mark.parametrize("mode", list(_MODES))
def test_cli_mesh_matches_no_mesh_and_jax(corpus, mode, n_dev, monkeypatch):
    """The host tiers without a mesh; with one, each mode's sharded
    function must have run, in the port as in kmerdb_tpu."""
    _no_device_tiers(monkeypatch)
    base = _cli(port_main, corpus, mode, f"{mode}.base.csv")
    ran = []
    for fn in ("all2all_counts_sharded", "many2all_counts_sharded",
               "db2db_counts_sharded", "all2all_rows_sharded"):
        real = getattr(sharded, fn)
        monkeypatch.setattr(sharded, fn, lambda *a, _f=fn, _r=real, **kw:
                            ran.append(_f) or _r(*a, **kw))
    got = _cli(port_main, corpus, mode, f"{mode}.mesh{n_dev}.csv",
               ["-mesh", n_dev])
    assert got == base and len(base) > 200
    assert set(ran) == _SHARDED[_MODES[mode][0]]
    assert _cli(jax_main, corpus, mode, f"{mode}.jax{n_dev}.csv",
                ["-mesh", n_dev]) == base


@pytest.mark.parametrize("mode", ["all2all-sp", "all2all-sp-sample-rows",
                                  "all2all-sp-sample-best"])
def test_cli_all2all_sp_matches_jax_on_both_tiers(corpus, mode, monkeypatch):
    outs = set()
    for tier in ("0", "1"):
        monkeypatch.setenv("KMERDB_A2A_DEVICE", tier)
        outs.add(_cli(port_main, corpus, mode, f"{mode}.port{tier}.csv"))
        outs.add(_cli(jax_main, corpus, mode, f"{mode}.jaxt{tier}.csv"))
    assert len(outs) == 1


@pytest.mark.parametrize("opts", [[], ["-min", "jaccard:0.02"]],
                         ids=["unfiltered", "filtered"])
def test_cli_all2all_parts_writes_all2all_sp_of_the_whole_database(
        corpus, opts, monkeypatch):
    """The parts are the database's samples in order, so both modes write
    the same rows: chip_smoke.py holds all2all-parts to all2all-sp's host
    tier CSV on the strength of this."""
    _no_device_tiers(monkeypatch)
    d = corpus
    outs = set()
    for main in (port_main, jax_main):
        for argv in (["all2all-sp", *opts, str(d / "db")],
                     ["all2all-parts", *opts, str(d / "parts.list")]):
            out = d / "whole.csv"
            assert main([*argv, str(out)]) == 0
            outs.add(out.read_bytes())
    assert len(outs) == 1 and len(outs.pop()) > 200


@pytest.mark.parametrize("n_dev", ["2", "8"])
@pytest.mark.parametrize("opts", [[], ["-sparse", "-min", "2"]],
                         ids=["dense", "sparse"])
def test_cli_mesh_streamed_matches_matrix_route_and_jax(corpus, opts, n_dev,
                                                        monkeypatch):
    """KMERDB_A2A_STREAM=1 forces the stripes below 16,384 samples: under a
    mesh they come from all2all_rows_sharded, with the count bounds applied
    by bounds_zero_rows for -sparse."""
    d = corpus
    _no_device_tiers(monkeypatch)
    base = d / f"stream{len(opts)}.base.csv"
    assert port_main(["all2all", *opts, str(d / "db"), str(base)]) == 0
    monkeypatch.setenv("KMERDB_A2A_STREAM", "1")
    seen = []
    real = gram.bounds_zero_rows
    monkeypatch.setattr(gram, "bounds_zero_rows", lambda C, b, dt:
                        seen.append(gram._unbias(b)) or real(C, b, dt))
    sharded.last_stats.clear()
    for main, name in ((port_main, "port"), (jax_main, "jax")):
        out = d / f"stream{len(opts)}.{name}{n_dev}.csv"
        assert main(["all2all", *opts, "-mesh", n_dev, str(d / "db"),
                     str(out)]) == 0
        assert out.read_bytes() == base.read_bytes()
    assert sharded.last_stats["slots"] == int(n_dev)
    assert seen == ([(2, U32_MAX)] * int(n_dev) if opts else [])


def test_cli_mesh_env_knob_and_one_device(corpus, monkeypatch):
    """KMERDB_MESH routes as -mesh does; -mesh 1 and 0 are no mesh."""
    _no_device_tiers(monkeypatch)
    base = _cli(port_main, corpus, "all2all", "env.base.csv")
    calls = []
    real = sharded.all2all_counts_sharded
    monkeypatch.setattr(sharded, "all2all_counts_sharded", lambda db, m:
                        calls.append(m.size) or real(db, m))
    monkeypatch.setenv("KMERDB_MESH", "5")
    assert _cli(port_main, corpus, "all2all", "env.mesh.csv") == base
    assert _cli(jax_main, corpus, "all2all", "env.jax.csv") == base
    for one in ("1", "0"):
        assert _cli(port_main, corpus, "all2all", f"env.one{one}.csv",
                    ["-mesh", one]) == base
    assert calls == [5]


@pytest.mark.parametrize("genv,tier", [("", None), ("1", "grid"),
                                       ("0", None)])
def test_mesh_turns_an_unforced_device_grid_off(genv, tier, monkeypatch,
                                                tmp_path):
    """kmerdb_tpu's rule: with a mesh, all2all-parts goes per cell through
    the sharded functions unless KMERDB_GRID_DEVICE=1 forces a grid."""
    from kmerdb_tpu_torch.cli import parts
    from kmerdb_tpu_torch.ops import fused
    monkeypatch.setenv("KMERDB_GRID_DEVICE", genv)
    monkeypatch.setattr(fused, "device_worthwhile", lambda S, n: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fns = []
    for i in range(3):
        fns.append(str(tmp_path / f"p{i}.db"))
        pathlib.Path(fns[-1]).write_bytes(b"x" * 1000)
    args = (fns, [1] * 3, [1] * 3, 1 << 20)
    assert parts._grid_tier(*args, make_mesh(2)) == tier
    assert parts._grid_tier(*args, None) == ("grid" if genv != "0" else None)


def test_cli_mesh_of_more_devices_than_present_exits_255(corpus, capsys):
    for main in (port_main, jax_main):
        assert main(["all2all", "-mesh", "9", str(corpus / "db"),
                     str(corpus / "nine.csv")]) == 255
        assert "requested 9 devices, have 8" in capsys.readouterr().err


def test_cli_mesh_on_a_machine_without_a_card_exits_255(corpus, monkeypatch,
                                                        capsys):
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_main(["all2all", "-mesh", "2", str(corpus / "db"),
                      str(corpus / "nocard.csv")]) == 255
    assert "CUDA" in capsys.readouterr().err


@pytest.mark.parametrize("mode,fn,env", [
    ("all2all", "all2all_rows_sharded", {"KMERDB_A2A_STREAM": "1"}),
    ("all2all", "all2all_counts_sharded", {}),
    ("all2all-sp", "all2all_counts_sharded", {}),
    ("new2all", "many2all_counts_sharded", {}),
    ("all2all-parts", "db2db_counts_sharded", {})])
def test_cli_sharded_failure_exits_255_without_recompute(corpus, mode, fn,
                                                         env, monkeypatch,
                                                         capsys):
    """No other route answers for a sharded one that failed."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    recomputed = []

    def boom(*a, **kw):
        raise RuntimeError("slot fault")

    monkeypatch.setattr(sharded, fn, boom)
    for name in ("all2all_counts", "many2all_counts", "db2db_counts"):
        monkeypatch.setattr(intersect, name,
                            lambda *a, **kw: recomputed.append(1))
    monkeypatch.setattr(device_a2a, "all2all_device_rows",
                        lambda *a, **kw: recomputed.append(1))
    argv = [a.format(d=corpus) for a in _MODES[mode]] + [
        str(corpus / "failed.csv"), "-mesh", "3"]
    assert port_main(argv) == 255
    out, err = capsys.readouterr()
    assert "slot fault" in err and "WARNING" not in out + err
    assert not recomputed
