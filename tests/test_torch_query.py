"""The port's new2all (batched query) and one2all paths against kmerdb_tpu's.

matmul_u32_acc's plain version (kmerdb_tpu_torch/ops/gram.py) is held to
kmerdb_tpu's Pallas kernel run in the interpreter, on the same numpy
operands; the port's many2all_counts on its device tier (device patched
to the CPU, so the plain version runs) to kmerdb_tpu's interpreted Mosaic
tier and to its host tier; the CLI's new2all and one2all CSVs to
kmerdb_tpu's, byte for byte.  Counts are integers mod 2^32, so every
comparison is exact.  The CUDA kernel itself is held to the plain version
on a card by tests/test_torch_cuda.py and chip_smoke.py.
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
from kmerdb_tpu_torch.cli.main import main as port_main
from kmerdb_tpu_torch.ops import gram, intersect

needs_native = pytest.mark.skipif(not native.available,
                                  reason="no native host runtime")


def _u32(rng, shape, lo=0, hi=1 << 32):
    return rng.integers(lo, hi, size=shape, dtype=np.uint64).astype(np.uint32)


@pytest.fixture
def on_cpu(monkeypatch):
    """The port's device tier on the CPU: its kernels' plain versions."""
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))


# (a) the kernel's plain version == kmerdb_tpu's interpreted kernel

@pytest.mark.parametrize("case", ["u8", "u32-3-limbs", "u32-4-limbs-high"])
def test_matmul_u32_acc_matches_jax(case):
    """Q 128, P 512, S 256 over a C seeded at 2^31 and above: uint8 H with
    every byte 0..255, uint32 H of 3 limbs, and of 4 limbs at 2^31 and
    above (negative in int32 storage)."""
    rng = np.random.default_rng(len(case))
    Q, P, S = 128, 512, 256
    B = (rng.random((P, S)) < 0.3).astype(np.int8)
    if case == "u8":
        H = rng.integers(0, 256, size=(Q, P), dtype=np.uint8)
        H[0, :256] = np.arange(256)
        n_limbs = 1
    elif case == "u32-3-limbs":
        H, n_limbs = _u32(rng, (Q, P), hi=1 << 24), 3
    else:
        H, n_limbs = _u32(rng, (Q, P), lo=1 << 31), 4
    C0 = _u32(rng, (Q, S), lo=1 << 31)

    want = np.asarray(pallas_gram.matmul_u32_acc(
        jnp.asarray(H), jnp.asarray(B), jnp.asarray(C0), n_limbs=n_limbs,
        interpret=True))
    np.testing.assert_array_equal(want, (
        (C0 + H.astype(np.uint64) @ B.astype(np.uint64)) & 0xFFFFFFFF)
        .astype(np.uint32))
    Ht = torch.from_numpy(H if H.dtype == np.uint8 else H.view(np.int32))
    Ct = torch.from_numpy(C0.view(np.int32).copy())
    got = gram.matmul_u32_acc(Ht, torch.from_numpy(B), Ct, n_limbs=n_limbs)
    assert got is Ct
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("bad", [
    "H_dtype", "B_dtype", "C_shape", "P_mismatch", "ragged", "u8_limbs",
    "limbs", "noncontiguous", "device"])
def test_matmul_wrapper_rejects_bad_operands(bad):
    H = torch.zeros((128, 256), dtype=torch.int32)
    B = torch.zeros((256, 128), dtype=torch.int8)
    C = torch.zeros((128, 128), dtype=torch.int32)
    n_limbs, err = 2, ValueError
    if bad == "H_dtype":
        H = H.to(torch.int64)
    elif bad == "B_dtype":
        B = B.to(torch.uint8)
    elif bad == "C_shape":
        C = torch.zeros((128, 256), dtype=torch.int32)
    elif bad == "P_mismatch":
        B = torch.zeros((384, 128), dtype=torch.int8)
    elif bad == "ragged":
        H, B = H[:, :200].contiguous(), B[:200].contiguous()
    elif bad == "u8_limbs":
        H = H.to(torch.uint8)
    elif bad == "limbs":
        n_limbs = 5
    elif bad == "noncontiguous":
        C = torch.zeros((128, 256), dtype=torch.int32)[:, ::2]
    else:
        H, B, C = (t.to("meta") for t in (H, B, C))
        err = RuntimeError
    with pytest.raises(err):
        gram.matmul_u32_acc(H, B, C, n_limbs=n_limbs)


def test_cpu_tensors_count_no_launch():
    n = gram.matmul_u32_acc.launches
    gram.matmul_u32_acc(torch.ones((128, 128), dtype=torch.uint8),
                        torch.ones((128, 128), dtype=torch.int8),
                        torch.zeros((128, 128), dtype=torch.int32), n_limbs=1)
    assert gram.matmul_u32_acc.launches == n


# (b) many2all_counts: port device tier == kmerdb_tpu Mosaic == host tier

def _db(seed, n_samples=6, n_kmers=400, core=0):
    """tests/test_device_tiers.py's random database; with `core`, every
    sample also holds the same `core` k-mers (one pattern that a query can
    hit that many times: hit counts past one 8-bit limb)."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 36, size=n_kmers, dtype=np.uint64)
    shared = rng.integers(1 << 37, 1 << 38, size=core, dtype=np.uint64)
    batch = []
    for i in range(n_samples):
        take = rng.random(n_kmers) < rng.uniform(0.2, 0.8)
        batch.append((f"s{i}", np.unique(np.concatenate([pool[take],
                                                         shared]))))
    db = builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        batch)
    return db, pool, shared


def _queries(seed, pool, n, extra=()):
    rng = np.random.default_rng(seed)
    qs = [np.unique(np.concatenate([
        rng.choice(pool, size=int(rng.integers(20, 200)), replace=False),
        rng.integers(1 << 39, 1 << 40, size=30, dtype=np.uint64)]))
        for _ in range(n)]
    return qs + [np.unique(np.asarray(q, dtype=np.uint64)) for q in extra]


def _case(name):
    if name == "u8":
        db, pool, _ = _db(2)
        return db, _queries(3, pool, 4), 1
    if name == "u32":
        db, pool, core = _db(9, core=600)
        return db, _queries(10, pool, 3, extra=[np.concatenate(
            [core, pool[:50]]), core[:300]]), 2
    if name == "empty-and-no-hit":
        db, pool, _ = _db(11)
        return db, _queries(12, pool, 2, extra=[
            [], np.arange(1 << 45, (1 << 45) + 40)]), 1
    # 130 queries (Q not a multiple of 128) over several pattern chunks
    db, pool, _ = _db(13, n_samples=9, n_kmers=700)
    return db, _queries(14, pool, 130), 1


@needs_native
@pytest.mark.parametrize("name", ["u8", "u32", "empty-and-no-hit",
                                  "chunked-130"])
def test_many2all_device_tier_matches_jax_tiers(name, monkeypatch, on_cpu,
                                                capsys):
    db, queries, n_limbs = _case(name)
    if name == "chunked-130":
        # a CSR element budget of 64 cuts the patterns into many chunks
        monkeypatch.setattr(jax_intersect, "_CHUNK_E", 64)
        monkeypatch.setattr(intersect, "_CHUNK_E", 64)
    H_all, B_all, got_limbs = intersect.m2a_prepare(db, queries)
    assert got_limbs == n_limbs
    assert H_all.dtype == (np.uint8 if n_limbs == 1 else np.uint32)
    assert H_all.shape[1] % 128 == 0 and B_all.shape[2] % 128 == 0
    assert H_all.shape[2] % 256 == 0
    if name == "chunked-130":
        assert H_all.shape[0] > 1 and len(queries) == 130

    host = jax_intersect.many2all_counts(db, queries, use_device=False)
    monkeypatch.setenv("KMERDB_N2A_DEVICE", "1")
    monkeypatch.setenv("KMERDB_A2A_PALLAS", "1")
    mosaic = jax_intersect.many2all_counts(db, queries)
    assert "falling back" not in capsys.readouterr().err
    intersect.n2a_stats.clear()
    got = intersect.many2all_counts(db, queries)
    assert intersect.n2a_stats["calls"] == 1
    assert intersect.n2a_stats["n_limbs"] == n_limbs
    assert got.dtype == np.uint32 and got.shape == (len(queries),
                                                    db.n_samples)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(mosaic, host)
    if name == "empty-and-no-hit":
        assert not got[-2:].any()
    if name == "u32":
        assert got.max() >= 600


@needs_native
@pytest.mark.parametrize("env,fixed_s,cuda,device", [
    ("1", "1e9", False, True), ("0", "0", True, False),
    ("", "0", True, True), ("", "0", False, False), ("", "1e9", True, False)])
def test_n2a_tier_choice(env, fixed_s, cuda, device, monkeypatch):
    """KMERDB_N2A_DEVICE forces a tier; unset, the device tier runs when
    the host estimate reaches fixed_s and CUDA is present."""
    db, pool, _ = _db(2)
    queries = _queries(3, pool, 3)
    monkeypatch.setenv("KMERDB_N2A_DEVICE", env)
    monkeypatch.setenv("KMERDB_COST_DEV_FIXED_S", fixed_s)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    ran = []
    monkeypatch.setattr(intersect, "_m2a_device",
                        lambda H, B, n, dev: ran.append(dev) or np.zeros(
                            (H.shape[1], B.shape[2]), np.uint32))
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))
    intersect.many2all_counts(db, queries)
    assert bool(ran) == device


# (c) the CLI, byte for byte

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 24-genome corpus: the database holds the first 16, the queries
    are all 24."""
    d = tmp_path_factory.mktemp("torch_query")
    lst = pathlib.Path(bench_corpus.generate(str(d / "corpus"),
                                             n_samples=24, genome_len=5000))
    paths = [ln for ln in lst.read_text().split() if ln]
    (d / "db.list").write_text("\n".join(paths[:16]) + "\n")
    db = str(d / "db")
    assert jax_main(["build", "-k", "18", str(d / "db.list"), db]) == 0
    return d, str(lst), db, paths


@needs_native
@pytest.mark.parametrize("opts", [
    [], ["-sparse", "-min", "num-kmers:3000"],
    ["-sparse", "-min", "jaccard:0.5"]],
    ids=["dense", "sparse-count", "sparse-metric"])
def test_cli_new2all_matches_jax_on_every_tier(corpus, opts, monkeypatch,
                                               on_cpu):
    d, lst, db, _ = corpus
    outs = {}
    for name, main, env in (("jax-host", jax_main, "0"),
                            ("port-host", port_main, "0"),
                            ("port-device", port_main, "1")):
        monkeypatch.setenv("KMERDB_N2A_DEVICE", env)
        intersect.n2a_stats.clear()
        out = d / f"{name}{len(opts)}{opts[-1] if opts else ''}.csv"
        assert main(["new2all", *opts, db, lst, str(out)]) == 0
        outs[name] = out.read_bytes()
        if main is port_main:
            assert bool(intersect.n2a_stats) == (env == "1")
    assert outs["port-device"] == outs["port-host"] == outs["jax-host"]
    assert outs["jax-host"].count(b"\n") == 2 + 24


@needs_native
def test_cli_one2all_matches_jax(corpus):
    d, _, db, paths = corpus
    outs = []
    for main in (jax_main, port_main):
        out = d / f"o2a{len(outs)}.csv"
        assert main(["one2all", db, paths[20] + ".fasta", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


@needs_native
def test_cli_new2all_kernel_failure_exits_255(corpus, monkeypatch, on_cpu,
                                              capsys):
    """A kernel that raises ends the run: no host recompute, no warning."""
    d, lst, db, _ = corpus
    recomputed = []

    def boom(*a, **kw):
        raise RuntimeError("matmul fault")

    monkeypatch.setenv("KMERDB_N2A_DEVICE", "1")
    monkeypatch.setattr(gram, "matmul_u32_acc", boom)
    monkeypatch.setattr(intersect, "_m2a_host",
                        lambda *a: recomputed.append(1))
    assert port_main(["new2all", db, lst, str(d / "failed.csv")]) == 255
    out, err = capsys.readouterr()
    assert "matmul fault" in err
    assert "WARNING" not in out + err and not recomputed


@needs_native
def test_forced_n2a_device_without_cuda_raises(corpus, monkeypatch, capsys):
    d, lst, db, _ = corpus
    monkeypatch.setenv("KMERDB_N2A_DEVICE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_main(["new2all", db, lst, str(d / "nocuda.csv")]) == 255
    assert "CUDA" in capsys.readouterr().err
