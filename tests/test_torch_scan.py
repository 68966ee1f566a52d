"""The port's scan tier (KMERDB_A2A_PALLAS=0) against kmerdb_tpu's.

The plain versions of gram_u32, gram_u32_tri and matmul_u32
(kmerdb_tpu_torch/ops/gram.py) are held to kmerdb_tpu's Pallas kernels run
in the interpreter, on the same numpy operands, at its own padding (P a
multiple of its KT 512, S of its TILE 128), with 8-bit-limb edges among the
weights and a case whose values pass 2^(8 * n_limbs) (the high bits are
dropped).  The port's all2all_counts and many2all_counts on the scan tier
(device patched to the CPU, so the plain versions run) are held to
kmerdb_tpu's scan tiers (its XLA limb scan) and to the host tiers, and the
CLI bytes under KMERDB_A2A_PALLAS=0 to kmerdb_tpu's.  Counts are integers
mod 2^32, so every comparison is exact.  The CUDA kernels themselves are
held to the plain versions on a card by tests/test_torch_cuda.py and
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
from kmerdb_tpu.utils import bench_corpus
from kmerdb_tpu_torch import _torchinit
from kmerdb_tpu_torch.cli.main import main as port_main
from kmerdb_tpu_torch.ops import device_a2a, gram, intersect
from kmerdb_tpu_torch.utils import native

from test_a2a_paths import _random_db
from test_torch_query import _case

needs_native = pytest.mark.skipif(not native.available,
                                  reason="no native host runtime")


def _weights(rng, n, n_limbs, case):
    """uint32[n] with the 8-bit-limb edges 255 and 2^8, and 2^31 and above
    at 4 limbs; "truncated" passes 2^(8 * n_limbs)."""
    hi = 1 << 32 if case == "truncated" else 1 << (8 * n_limbs)
    w = rng.integers(0, hi, size=n, dtype=np.uint64).astype(np.uint32)
    edges = [255, 0, hi - 1] + ([256] if n_limbs > 1 else []) + \
        ([1 << 31, (1 << 31) + 7] if n_limbs == 4 or case == "truncated"
         else [])
    w[:len(edges)] = np.array(edges, dtype=np.uint64).astype(np.uint32)
    return w


def _oracle(a, b, n_limbs):
    """(a & mask) @ b mod 2^32, in Python integers' numpy form."""
    mask = np.uint64((1 << (8 * n_limbs)) - 1)
    prod = (a.astype(np.uint64) & mask) @ b.astype(np.uint64)
    return (prod & np.uint64(0xFFFFFFFF)).astype(np.uint32)


GRAM_CASES = [(1, "limbs"), (2, "limbs"), (3, "limbs"), (4, "limbs"),
              (1, "truncated"), (2, "truncated")]


@pytest.mark.parametrize("n_limbs,case", GRAM_CASES,
                         ids=[f"{n}-{c}" for n, c in GRAM_CASES])
def test_gram_u32_matches_jax(n_limbs, case):
    rng = np.random.default_rng(10 * n_limbs + len(case))
    P, S = 2 * pallas_gram.KT, 256
    B = (rng.random((P, S)) < 0.3).astype(np.int8)
    w = _weights(rng, P, n_limbs, case)
    want = np.asarray(pallas_gram.gram_u32(
        jnp.asarray(B), jnp.asarray(w).reshape(-1, 1), n_limbs=n_limbs,
        interpret=True))
    np.testing.assert_array_equal(want, _oracle(B.T * w, B, n_limbs))
    got = gram.gram_u32(torch.from_numpy(B), torch.from_numpy(w.view(np.int32)),
                        n_limbs=n_limbs)
    assert got.dtype == torch.int32 and got.shape == (S, S)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("n_limbs,case", [(1, "limbs"), (3, "limbs"),
                                          (4, "limbs"), (2, "truncated")])
def test_gram_u32_tri_matches_jax_on_the_lower_tiles(n_limbs, case):
    """Three tile rows: the t -> (i, j) decoding of the triangle grid."""
    rng = np.random.default_rng(20 + n_limbs)
    P, S = pallas_gram.KT, 3 * pallas_gram.TILE
    B = (rng.random((P, S)) < 0.3).astype(np.int8)
    w = _weights(rng, P, n_limbs, case)
    want = np.asarray(pallas_gram.gram_u32_tri(
        jnp.asarray(B), jnp.asarray(w).reshape(-1, 1), n_limbs=n_limbs,
        interpret=True))
    got = gram.gram_u32_tri(torch.from_numpy(B),
                            torch.from_numpy(w.view(np.int32)),
                            n_limbs=n_limbs).numpy().view(np.uint32)
    band = np.arange(S) // gram.BLOCK
    lower = band[:, None] >= band[None, :]
    np.testing.assert_array_equal(got[lower], want[lower])
    assert not got[~lower].any()
    full = np.tril(got) + np.tril(got, -1).T
    np.testing.assert_array_equal(full, _oracle(B.T * w, B, n_limbs))


MATMUL_CASES = [("u8", 1), ("u32", 2), ("u32", 4), ("truncated", 2)]


@pytest.mark.parametrize("h,n_limbs", MATMUL_CASES,
                         ids=[f"{h}-{n}" for h, n in MATMUL_CASES])
def test_matmul_u32_matches_jax(h, n_limbs):
    """uint8 H over every byte, uint32 H of 2 and of 4 limbs (2^31 and above:
    negative in int32 storage), and 2-limb H with values past 2^16."""
    rng = np.random.default_rng(30 + n_limbs + len(h))
    Q, P, S = 128, pallas_gram.KT, 256
    B = (rng.random((P, S)) < 0.3).astype(np.int8)
    if h == "u8":
        H = rng.integers(0, 256, size=(Q, P), dtype=np.uint8)
        H[0, :256] = np.arange(256)
    else:
        H = _weights(rng, Q * P, n_limbs,
                     "truncated" if h == "truncated" else "limbs")
        H = H.reshape(Q, P)
    want = np.asarray(pallas_gram.matmul_u32(
        jnp.asarray(H), jnp.asarray(B), n_limbs=n_limbs, interpret=True))
    np.testing.assert_array_equal(want, _oracle(H, B, n_limbs))
    Ht = torch.from_numpy(H if H.dtype == np.uint8 else H.view(np.int32))
    got = gram.matmul_u32(Ht, torch.from_numpy(B), n_limbs=n_limbs)
    assert got.dtype == torch.int32 and got.shape == (Q, S)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("bad", ["B_dtype", "w_dtype", "w_size", "ragged_P",
                                 "ragged_S", "limbs", "noncontiguous",
                                 "device"])
def test_gram_wrappers_reject_bad_operands(bad):
    B = torch.zeros((256, 128), dtype=torch.int8)
    w = torch.zeros(256, dtype=torch.int32)
    n_limbs, err = 2, ValueError
    if bad == "B_dtype":
        B = B.to(torch.uint8)
    elif bad == "w_dtype":
        w = w.to(torch.int64)
    elif bad == "w_size":
        w = w[:128].contiguous()
    elif bad == "ragged_P":
        B, w = B[:200].contiguous(), w[:200].contiguous()
    elif bad == "ragged_S":
        B = torch.zeros((256, 200), dtype=torch.int8)
    elif bad == "limbs":
        n_limbs = 5
    elif bad == "noncontiguous":
        B = torch.zeros((256, 256), dtype=torch.int8)[:, ::2]
    else:
        B, w = B.to("meta"), w.to("meta")
        err = RuntimeError
    for fn in (gram.gram_u32, gram.gram_u32_tri):
        with pytest.raises(err):
            fn(B, w, n_limbs=n_limbs)


def test_cpu_tensors_count_no_launch():
    B = torch.ones((128, 128), dtype=torch.int8)
    w = torch.ones(128, dtype=torch.int32)
    before = [f.launches for f in (gram.gram_u32, gram.gram_u32_tri,
                                   gram.matmul_u32)]
    gram.gram_u32(B, w, n_limbs=1)
    gram.gram_u32_tri(B, w, n_limbs=1)
    gram.matmul_u32(B.view(torch.uint8), B, n_limbs=1)
    assert before == [f.launches for f in (gram.gram_u32, gram.gram_u32_tri,
                                           gram.matmul_u32)]


# (b) the scan tier == kmerdb_tpu's scan tier == the host tier

@pytest.fixture
def scan_on_cpu(monkeypatch):
    """The port's scan tier on the CPU (its kernels' plain versions), and
    kmerdb_tpu's on its XLA limb scan."""
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))
    monkeypatch.setenv("KMERDB_A2A_PALLAS", "0")
    intersect.scan_stats.clear()


def _wraparound_db():
    """tests/test_a2a_paths.py's wraparound case: 0xF0000000 * 2 +
    0x30000000 wraps mod 2^32."""
    from kmerdb_tpu.models.database import KmerPatternDb
    return KmerPatternDb(
        kmer_length=18, sample_names=list("abcd"),
        sample_kmer_counts=np.ones(4, np.uint32),
        pattern_offsets=np.array([0, 2, 4, 6], dtype=np.int64),
        pattern_sample_ids=np.array([0, 1, 0, 1, 0, 1], dtype=np.uint32),
        pattern_num_kmers=np.array([0xF0000000, 0xF0000000, 0x30000000],
                                   dtype=np.uint32))


A2A_CASES = ["light", "heavy", "chunked", "wraparound"]


@needs_native
@pytest.mark.parametrize("name", A2A_CASES)
def test_a2a_scan_matches_jax_and_host(name, scan_on_cpu, monkeypatch):
    rng = np.random.default_rng(A2A_CASES.index(name))
    if name == "light":
        db = _random_db(rng, 130, 300, max_w=200)
    elif name == "heavy":
        db = _random_db(rng, 200, 400)           # weights to 300,000
    elif name == "chunked":
        db = _random_db(rng, 64, 400)
        for mod in (intersect, jax_intersect):    # many chunks
            monkeypatch.setattr(mod, "_CHUNK_E", 300)
    else:
        db = _wraparound_db()
    host = native.a2a_dense(db.pattern_offsets, db.pattern_sample_ids,
                            db.pattern_num_kmers, db.n_samples)
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "1")
    jax_scan = jax_intersect.all2all_counts(db)
    got = intersect.all2all_counts(db)
    full = intersect._a2a_scan(db, triangle=False)
    assert got.dtype == np.uint32 and got.shape == host.shape
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(full, host)
    np.testing.assert_array_equal(jax_scan, host)
    st = intersect.scan_stats
    assert st["calls"] == 2
    if name == "chunked":
        assert st["chunks"] > 2 * 4
    if name == "wraparound":
        assert got[0, 1] == (0xF0000000 * 2 + 0x30000000) % (1 << 32)


@needs_native
@pytest.mark.parametrize("pallas,scan", [("0", True), ("1", False),
                                         (None, False)])
def test_a2a_device_tier_routes_on_the_pallas_knob(pallas, scan, monkeypatch):
    """KMERDB_A2A_PALLAS=0 takes the scan; unset or 1 the packed tier."""
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "1")
    if pallas is None:
        monkeypatch.delenv("KMERDB_A2A_PALLAS", raising=False)
    else:
        monkeypatch.setenv("KMERDB_A2A_PALLAS", pallas)
    ran = []
    real_scan, real_packed = intersect._a2a_scan, device_a2a.all2all_device
    monkeypatch.setattr(intersect, "_a2a_scan",
                        lambda db: ran.append("scan") or real_scan(db))
    monkeypatch.setattr(device_a2a, "all2all_device",
                        lambda db: ran.append("packed") or real_packed(db))
    # counts below 2^16, as the packed tier's uint16 pull assumes of a
    # database whose sample k-mer counts (here all 1) fit it
    db = _random_db(np.random.default_rng(5), 40, 100, max_w=200)
    host = native.a2a_dense(db.pattern_offsets, db.pattern_sample_ids,
                            db.pattern_num_kmers, db.n_samples)
    np.testing.assert_array_equal(intersect.all2all_counts(db), host)
    assert ran == ["scan" if scan else "packed"]


@needs_native
@pytest.mark.parametrize("name", ["u8", "u32", "empty-and-no-hit",
                                  "chunked-130"])
def test_m2a_scan_matches_jax_and_host(name, scan_on_cpu, monkeypatch):
    db, queries, n_limbs = _case(name)
    if name == "chunked-130":
        for mod in (intersect, jax_intersect):
            monkeypatch.setattr(mod, "_CHUNK_E", 64)
    host = jax_intersect.many2all_counts(db, queries, use_device=False)
    monkeypatch.setenv("KMERDB_N2A_DEVICE", "1")
    jax_scan = jax_intersect.many2all_counts(db, queries)
    intersect.n2a_stats.clear()
    got = intersect.many2all_counts(db, queries)
    assert got.dtype == np.uint32 and got.shape == host.shape
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(jax_scan, host)
    assert intersect.n2a_stats["n_limbs"] == n_limbs
    assert intersect.scan_stats["calls"] == 1
    assert intersect.scan_stats["chunks"] == intersect.n2a_stats["chunks"]
    if name == "chunked-130":
        assert intersect.scan_stats["chunks"] > 1


# (c) the CLI, byte for byte

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 20-genome corpus: the database holds the first 14, the queries
    are all 20."""
    d = tmp_path_factory.mktemp("torch_scan")
    lst = pathlib.Path(bench_corpus.generate(str(d / "corpus"),
                                             n_samples=20, genome_len=4000))
    paths = [ln for ln in lst.read_text().split() if ln]
    (d / "db.list").write_text("\n".join(paths[:14]) + "\n")
    db = str(d / "db")
    assert jax_main(["build", "-k", "18", str(d / "db.list"), db]) == 0
    return d, str(lst), db


CLI_CASES = [("all2all", []), ("all2all", ["-sparse", "-min", "jaccard:0.3"]),
             ("new2all", []), ("new2all", ["-sparse", "-min", "num-kmers:2500"])]


@needs_native
@pytest.mark.parametrize("mode,opts", CLI_CASES,
                         ids=[f"{m}-{'sparse' if o else 'dense'}"
                              for m, o in CLI_CASES])
def test_cli_scan_tier_matches_jax(corpus, mode, opts, scan_on_cpu,
                                   monkeypatch):
    d, lst, db = corpus
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "1")
    monkeypatch.setenv("KMERDB_N2A_DEVICE", "1")
    ins = [db] if mode == "all2all" else [db, lst]
    outs = {}
    for side, main in (("jax", jax_main), ("port", port_main)):
        out = d / f"{side}-{mode}-{len(opts)}.csv"
        assert main([mode, *opts, *ins, str(out)]) == 0
        outs[side] = out.read_bytes()
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "0")
    monkeypatch.setenv("KMERDB_N2A_DEVICE", "0")
    host = d / f"host-{mode}-{len(opts)}.csv"
    assert port_main([mode, *opts, *ins, str(host)]) == 0
    assert outs["port"] == outs["jax"] == host.read_bytes()
    assert intersect.scan_stats["calls"] >= 1


@needs_native
@pytest.mark.parametrize("mode", ["all2all", "new2all"])
def test_cli_scan_kernel_failure_exits_255(corpus, mode, scan_on_cpu,
                                           monkeypatch, capsys):
    """A scan kernel that raises ends the run: no host or packed-tier
    recompute, no warning."""
    d, lst, db = corpus
    recomputed = []

    def boom(*a, **kw):
        raise RuntimeError("scan kernel fault")

    def record(*a, **kw):
        recomputed.append(1)

    for name in ("gram_u32_tri", "gram_u32", "matmul_u32"):
        monkeypatch.setattr(gram, name, boom)
    monkeypatch.setattr(device_a2a, "all2all_device", record)
    monkeypatch.setattr(intersect, "_m2a_device", record)
    monkeypatch.setattr(intersect, "_m2a_host", record)
    monkeypatch.setattr(native, "a2a_dense", record)
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "1")
    monkeypatch.setenv("KMERDB_N2A_DEVICE", "1")
    ins = [db] if mode == "all2all" else [db, lst]
    assert port_main([mode, *ins, str(d / "failed.csv")]) == 255
    out, err = capsys.readouterr()
    assert "scan kernel fault" in err
    assert "WARNING" not in out + err and not recomputed
