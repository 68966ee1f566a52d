"""The port's db2db and all2all-parts grid against kmerdb_tpu's.

cross_u32_pk's plain version (kmerdb_tpu_torch/ops/gram.py) is held to
kmerdb_tpu's Pallas kernel run in the interpreter, on the same numpy
operands; the port's db2db device tier and its two device grids (device
patched to the CPU, so the plain versions run) to kmerdb_tpu's host
db2db_counts and all2all_counts per cell; the CLI's all2all-parts CSVs,
under every tier, to kmerdb_tpu's, byte for byte.  Counts are integers
mod 2^32, so every comparison is exact.  The CUDA kernel itself is held to
the plain version on a card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerdb_tpu.cli.main import main as jax_main
from kmerdb_tpu.models import builder
from kmerdb_tpu.models.database import KmerPatternDb
from kmerdb_tpu.ops import intersect as jax_intersect
from kmerdb_tpu.ops import pallas_gram
from kmerdb_tpu.utils import bench_corpus, native
from kmerdb_tpu_torch import _torchinit
from kmerdb_tpu_torch.cli import parts
from kmerdb_tpu_torch.cli.main import main as port_main
from kmerdb_tpu_torch.ops import fused, gram, intersect

needs_native = pytest.mark.skipif(not native.available,
                                  reason="no native host runtime")


def _u32(rng, shape, lo=0, hi=1 << 32):
    return rng.integers(lo, hi, size=shape, dtype=np.uint64).astype(np.uint32)


def _pack(B: np.ndarray) -> np.ndarray:
    Bp = np.zeros((B.shape[0] // 8, B.shape[1]), dtype=np.uint8)
    for i in range(B.shape[0]):
        Bp[i >> 3] |= B[i] << np.uint8(i & 7)
    return Bp


@pytest.fixture
def on_cpu(monkeypatch):
    """The port's device tier on the CPU: its kernels' plain versions."""
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))


# (a) the kernel's plain version == kmerdb_tpu's interpreted kernel

@pytest.mark.parametrize("jax_kt,port_kt", [(512, 1024), (1024, 256)])
def test_cross_u32_pk_matches_jax(jax_kt, port_kt):
    """S1 128 x S2 256, distinct weights up to 2^20 (three 7-bit limbs),
    each side's weights in its own kt's order, C seeded non-zero."""
    rng = np.random.default_rng(jax_kt + port_kt)
    P, S1, S2 = 2048, 128, 256
    U = (rng.random((P, S1)) < 0.3).astype(np.uint8)
    V = (rng.random((P, S2)) < 0.3).astype(np.uint8)
    w = _u32(rng, P, hi=1 << 20)
    assert np.unique(w).size > P // 2
    C0 = _u32(rng, (S1, S2))
    want = np.asarray(pallas_gram.cross_u32_pk(
        jnp.asarray(_pack(U)), jnp.asarray(_pack(V)),
        jnp.asarray(pallas_gram.pk_weight_order(w, jax_kt).reshape(-1, 1)),
        jnp.asarray(C0), n_limbs=3, kt=jax_kt, tile=128, engine="s8",
        interpret=True))
    np.testing.assert_array_equal(want, (
        (C0 + (U.T.astype(np.uint64) * w.astype(np.uint64)) @ V)
        & 0xFFFFFFFF).astype(np.uint32))
    Ut = torch.from_numpy(_pack(U))
    Vt = torch.from_numpy(_pack(V))
    wt = torch.from_numpy(gram.pk_weight_order(w, port_kt).view(np.int32))
    Ct = torch.from_numpy(C0.view(np.int32).copy())
    got = gram.cross_u32_pk(Ut, Vt, wt, Ct, n_limbs=3, kt=port_kt)
    assert got is Ct
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("bad", [
    "Vp_rows", "Vp_dtype", "C_shape", "ragged", "kt", "limbs", "device"])
def test_cross_wrapper_rejects_bad_operands(bad):
    Up = torch.zeros((32, 128), dtype=torch.uint8)
    Vp = torch.zeros((32, 256), dtype=torch.uint8)
    w = torch.zeros(256, dtype=torch.int32)
    C = torch.zeros((128, 256), dtype=torch.int32)
    kw, err = dict(n_limbs=1, kt=256), ValueError
    if bad == "Vp_rows":
        Vp = torch.zeros((64, 256), dtype=torch.uint8)
    elif bad == "Vp_dtype":
        Vp = Vp.to(torch.int8)
    elif bad == "C_shape":
        C = torch.zeros((256, 128), dtype=torch.int32)
    elif bad == "ragged":
        Vp, C = Vp[:, :200].contiguous(), C[:, :200].contiguous()
    elif bad == "kt":
        kw["kt"] = 192
    elif bad == "limbs":
        kw["n_limbs"] = 6
    else:
        Up, Vp, w, C = (t.to("meta") for t in (Up, Vp, w, C))
        err = RuntimeError
    with pytest.raises(err):
        gram.cross_u32_pk(Up, Vp, w, C, **kw)


def test_two_operand_gram_is_the_gram_with_one():
    """The triangle Gram's plain version is the cross Gram of B with
    itself on the lower tiles."""
    rng = np.random.default_rng(3)
    Bp = torch.from_numpy(rng.integers(0, 256, size=(64, 256),
                                       dtype=np.uint8))
    w = torch.from_numpy(_u32(rng, 512, hi=1 << 14).view(np.int32))
    tri = gram.gram_u32_pk_tri(Bp, w, torch.zeros((256, 256),
                                                  dtype=torch.int32),
                               n_limbs=2)
    full = gram.cross_u32_pk(Bp, Bp, w, torch.zeros((256, 256),
                                                    dtype=torch.int32),
                             n_limbs=2)
    assert torch.equal(tri[128:, :128], full[128:, :128])
    assert torch.equal(full, full.T)
    assert not tri[:128, 128:].any()


# (b) db2db: port device tier == kmerdb_tpu host tier

def _parts_dbs(rng, sizes, pool_size=6000, core_size=2500):
    """tests/test_fused.py's parts: a shared core plus random extras."""
    pool = rng.integers(0, 1 << 40, size=pool_size, dtype=np.uint64)
    core = np.unique(pool[:core_size])
    dbs = []
    for pi, n in enumerate(sizes):
        samples = []
        for i in range(n):
            extra = np.unique(rng.choice(
                pool, size=int(rng.integers(60, 500)), replace=False))
            samples.append((f"p{pi}s{i}", np.unique(
                np.concatenate([core, extra]))))
        dbs.append(_built(samples))
    return dbs


def _built(samples):
    return builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        samples)


def _disjoint_db(rng, n=6):
    return _built([(f"q{i}", np.unique(
        rng.integers(1 << 41, 1 << 42, size=300, dtype=np.uint64)))
        for i in range(n)])


@needs_native
def test_db2db_device_tier_matches_jax_host(monkeypatch, on_cpu):
    """A pattern pair sharing a core of 17,000 k-mers (past 2^14: three
    7-bit limbs), databases that share nothing."""
    rng = np.random.default_rng(6)
    a, b = _parts_dbs(rng, [5, 7], pool_size=20_000, core_size=17_000)
    c = _disjoint_db(rng)
    ran = []
    real = intersect._d2d_device
    monkeypatch.setattr(intersect, "_d2d_device",
                        lambda *a, **k: ran.append(1) or real(*a, **k))
    monkeypatch.setenv("KMERDB_D2D_DEVICE", "1")
    for row, col, shares in ((a, b, True), (b, a, True), (a, c, False)):
        host = jax_intersect.db2db_counts(row, col)
        got = intersect.db2db_counts(row, col)
        assert got.dtype == np.uint32 and got.shape == host.shape
        np.testing.assert_array_equal(got, host)
        assert bool(host.max()) == shares
    assert len(ran) == 2 and int(host.max()) == 0
    assert int(jax_intersect.db2db_counts(a, b).max()) >= 1 << 14


@needs_native
@pytest.mark.parametrize("env,fixed_s,cuda,device", [
    ("1", "1e9", False, True), ("0", "0", True, False),
    ("", "0", True, True), ("", "0", False, False), ("", "1e9", True, False)])
def test_d2d_tier_choice(env, fixed_s, cuda, device, monkeypatch):
    rng = np.random.default_rng(7)
    a, b = _parts_dbs(rng, [3, 4], pool_size=800, core_size=100)
    monkeypatch.setenv("KMERDB_D2D_DEVICE", env)
    monkeypatch.setenv("KMERDB_COST_DEV_FIXED_S", fixed_s)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    ran = []
    monkeypatch.setattr(intersect, "_d2d_device",
                        lambda *a, **k: ran.append(1))
    intersect.db2db_counts(a, b)
    assert bool(ran) == device


# (c) the device grids: every cell == kmerdb_tpu's per-cell host tiers

def _check_cells(dbs, cells):
    for i in range(len(dbs)):
        np.testing.assert_array_equal(
            cells[i][i], jax_intersect.all2all_counts(dbs[i]),
            err_msg=f"diagonal {i}")
        for j in range(i):
            np.testing.assert_array_equal(
                cells[i][j], jax_intersect.db2db_counts(dbs[i], dbs[j]),
                err_msg=f"cell {i},{j}")


@needs_native
@pytest.mark.parametrize("with_disjoint", [False, True])
def test_grid_group_counts_matches_cell_kernels(with_disjoint, monkeypatch,
                                                on_cpu):
    """Mixed part sizes; a part that shares no k-mer with the others; a
    chunk budget small enough that some chunks skip parts."""
    monkeypatch.setenv("KMERDB_A2A_GROUP_MB", "0")      # one K block a chunk
    rng = np.random.default_rng(8)
    dbs = _parts_dbs(rng, [9, 5, 12])
    if with_disjoint:
        dbs.insert(1, _disjoint_db(rng))
    grid = fused.grid_group_counts(dbs)
    cells = {i: {j: grid[i, j] for j in range(i + 1)}
             for i in range(len(dbs))}
    _check_cells(dbs, cells)
    st = fused.last_stats
    assert st["chunk_rows"] == 256 and st["device"] == "cpu"
    assert (st["skipped_products"] > 0) == with_disjoint


@needs_native
@pytest.mark.parametrize("resident_mb", ["4096", "0"],
                         ids=["resident", "repushed"])
def test_grid_rows_streamed_matches_cell_kernels(resident_mb, monkeypatch,
                                                 on_cpu):
    monkeypatch.setenv("KMERDB_A2A_RESIDENT_MB", resident_mb)
    monkeypatch.setenv("KMERDB_A2A_GROUP_MB", "0")
    rng = np.random.default_rng(9)
    dbs = _parts_dbs(rng, [9, 5, 12])
    dbs.append(_disjoint_db(rng, 4))
    cells = {}
    for i_row, row in fused.grid_rows_streamed(
            lambda i: dbs[i], [db.n_samples for db in dbs], max_count=10**9):
        assert sorted(row) == list(range(i_row + 1))
        cells[i_row] = row
    _check_cells(dbs, cells)
    st = fused.last_stats
    assert st["resident_rows"] == (resident_mb != "0")
    assert st["rows_done"] == 4 and st["skipped_products"] > 0
    assert not st["narrow"]


@pytest.mark.parametrize("genv,senv,n_parts,worth,cuda,big,tier", [
    ("1", "", 1, False, False, False, "grid"),
    ("1", "1", 3, False, False, False, "stream"),
    ("0", "1", 3, True, True, True, None),
    ("", "", 1, True, True, False, None),
    ("", "", 3, False, True, False, None),
    ("", "", 3, True, False, False, None),
    ("", "", 3, True, True, False, "grid"),
    ("", "", 3, True, True, True, "stream"),
    ("", "0", 3, True, True, True, "grid")])
def test_grid_tier_choice(genv, senv, n_parts, worth, cuda, big, tier,
                          monkeypatch, tmp_path):
    """KMERDB_GRID_DEVICE and KMERDB_GRID_STREAM force; unset, the grid runs
    for more than one part when worthwhile and CUDA is present, streamed
    when 4x the files exceed the cache budget."""
    monkeypatch.setenv("KMERDB_GRID_DEVICE", genv)
    monkeypatch.setenv("KMERDB_GRID_STREAM", senv)
    monkeypatch.setattr(fused, "device_worthwhile", lambda S, n: worth)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    fns = []
    for i in range(n_parts):
        f = tmp_path / f"p{i}.db"
        f.write_bytes(b"x" * 1000)
        fns.append(str(f))
    budget = 1000 * 4 * n_parts - (1 if big else 0)
    assert parts._grid_tier(fns, [1] * n_parts, [1] * n_parts, budget) \
        == tier


def test_device_worthwhile_is_the_host_estimate(monkeypatch):
    """total k-mers x S/4 at the host scatter rate against fixed_s."""
    monkeypatch.setenv("KMERDB_COST_HOST_RATE", "1e9")
    monkeypatch.setenv("KMERDB_COST_HOST_RATE_BIG", "1e8")
    monkeypatch.setenv("KMERDB_COST_DEV_FIXED_S", "8")
    assert fused.device_worthwhile(1000, 32_000_000)        # 8.0 s
    assert not fused.device_worthwhile(1000, 31_999_999)
    assert fused.device_worthwhile(2000, 1_600_000)         # 8.0 s, big rate


# (d) the CLI, byte for byte

@pytest.fixture(scope="module")
def part_list(tmp_path_factory):
    """18 genomes in three part databases of 6, built by kmerdb_tpu."""
    d = tmp_path_factory.mktemp("torch_parts")
    lst = pathlib.Path(bench_corpus.generate(str(d / "corpus"),
                                             n_samples=18, genome_len=4000))
    paths = [ln for ln in lst.read_text().split() if ln]
    dbs = []
    for pi in range(3):
        (d / f"p{pi}.list").write_text(
            "\n".join(paths[pi * 6:(pi + 1) * 6]) + "\n")
        dbs.append(str(d / f"p{pi}.db"))
        assert jax_main(["build", "-k", "18", str(d / f"p{pi}.list"),
                         dbs[-1]]) == 0
    (d / "dbs.list").write_text("\n".join(dbs) + "\n")
    return d, str(d / "dbs.list")


_TIERS = {
    "grid": {"KMERDB_GRID_DEVICE": "1"},
    "streamed-grid": {"KMERDB_GRID_DEVICE": "1", "KMERDB_GRID_STREAM": "1"},
    "per-cell-device": {"KMERDB_GRID_DEVICE": "0", "KMERDB_D2D_DEVICE": "1",
                        "KMERDB_A2A_DEVICE": "1"},
    "host": {"KMERDB_GRID_DEVICE": "0", "KMERDB_D2D_DEVICE": "0",
             "KMERDB_A2A_DEVICE": "0"},
}


@pytest.fixture(scope="module")
def jax_parts_csvs(part_list):
    """kmerdb_tpu's all2all-parts CSVs on its host tiers."""
    d, dbl = part_list
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in _TIERS["host"].items():
            mp.setenv(k, v)
        for opts in ((), ("-min", "2000")):
            f = d / f"jax{len(opts)}.csv"
            assert jax_main(["all2all-parts", *opts, dbl, str(f)]) == 0
            out[opts] = f.read_bytes()
    return out


@needs_native
@pytest.mark.parametrize("opts", [(), ("-min", "2000")],
                         ids=["plain", "filtered"])
@pytest.mark.parametrize("tier", list(_TIERS))
def test_cli_parts_matches_jax_on_every_tier(part_list, jax_parts_csvs, tier,
                                             opts, monkeypatch, on_cpu):
    d, dbl = part_list
    for k, v in _TIERS[tier].items():
        monkeypatch.setenv(k, v)
    fused.last_stats.clear()
    out = d / f"port-{tier}{len(opts)}.csv"
    assert port_main(["all2all-parts", *opts, dbl, str(out)]) == 0
    assert out.read_bytes() == jax_parts_csvs[opts]
    assert bool(fused.last_stats) == ("grid" in tier)
    assert out.read_bytes().count(b"\n") == 2 + 18


@needs_native
@pytest.mark.parametrize("tier", ["grid", "streamed-grid"])
def test_cli_parts_kernel_failure_exits_255(part_list, tier, monkeypatch,
                                            on_cpu, capsys):
    """A cross kernel that raises ends the run: no cell is recomputed."""
    d, dbl = part_list
    recomputed = []

    def boom(*a, **kw):
        raise RuntimeError("cross fault")

    for k, v in _TIERS[tier].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(gram, "cross_u32_pk", boom)
    for name in ("db2db_counts", "all2all_counts"):
        monkeypatch.setattr(intersect, name,
                            lambda *a, **k: recomputed.append(1))
    assert port_main(["all2all-parts", dbl, str(d / "failed.csv")]) == 255
    out, err = capsys.readouterr()
    assert "cross fault" in err
    assert "WARNING" not in out + err and not recomputed
