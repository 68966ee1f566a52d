"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs a CUDA card and nvcc, carries the ``cuda`` marker
and skips elsewhere.  The file imports no jax (the machine with the card
has none), so it runs there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kmerdb_tpu.models.database import KmerPatternDb
from kmerdb_tpu.utils import native
from kmerdb_tpu_torch.ops import device_a2a, gram

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape,
                        dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("S,rows,n_limbs,kt,tile", [
    (256, 1024, 1, 256, 128), (640, 2048, 5, 1024, 128),
    (1024, 2048, 3, 512, 512)])
def test_gram_kernel_matches_plain(card, S, rows, n_limbs, kt, tile):
    rng = np.random.default_rng(S + n_limbs)
    Bp = rng.integers(0, 256, size=(rows // 8, S), dtype=np.uint8)
    w = _u32(rng, rows) >> np.uint32(max(0, 32 - 7 * n_limbs))
    Bt, wt, Ct = gram.from_jax_layout(Bp, gram.pk_weight_order(w, kt),
                                      _u32(rng, (S, S)), card)
    n = gram.gram_u32_pk_tri.launches
    plain = gram.gram_u32_pk_tri_plain(Bt, wt, Ct.clone(), n_limbs=n_limbs,
                                       kt=kt, tile=tile)
    gram.gram_u32_pk_tri(Bt, wt, Ct, n_limbs=n_limbs, kt=kt, tile=tile)
    torch.cuda.synchronize()
    assert gram.gram_u32_pk_tri.launches == n + 1
    assert torch.equal(Ct, plain)


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_tril_kernel_matches_plain(card, dtype):
    rng = np.random.default_rng(11)
    C = torch.from_numpy(_u32(rng, (640, 640)).view(np.int32)).to(card)
    n = gram.tril_tiles.launches
    got = gram.tril_tiles(C, dtype)
    torch.cuda.synchronize()
    assert gram.tril_tiles.launches == n + 1
    assert torch.equal(got, gram.tril_tiles_plain(C, dtype))


def test_misaligned_operand_is_refused(card):
    C = torch.zeros(256 * 256 + 1, dtype=torch.int32, device=card)[1:]
    with pytest.raises(ValueError, match="aligned"):
        gram.tril_tiles(C.view(256, 256))


def _random_db(S=300, P=3000, max_w=1 << 20):
    rng = np.random.default_rng(2)
    lens = rng.integers(1, 40, size=P)
    offs = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    sids = np.concatenate([np.sort(rng.choice(S, size=k, replace=False))
                           for k in lens]).astype(np.uint32)
    w = rng.integers(1, max_w, size=P).astype(np.uint32)
    host = native.a2a_dense(offs, sids, w, S)
    db = KmerPatternDb(kmer_length=18,
                       sample_names=[f"s{i}" for i in range(S)],
                       sample_kmer_counts=np.diag(host).copy(),
                       pattern_offsets=offs, pattern_sample_ids=sids,
                       pattern_num_kmers=w)
    return db, host


@pytest.mark.skipif(not native.available, reason="no native host runtime")
def test_all2all_device_matches_host_tier(card):
    db, host = _random_db()
    np.testing.assert_array_equal(device_a2a.all2all_device(db), host)
    assert device_a2a.last_stats["device"] == "cuda"
    assert device_a2a.last_stats["gram_s"] > 0


@pytest.mark.parametrize("S,rows,n_limbs,kt,tile,nrt,rt0", [
    (384, 1024, 1, 256, 128, 1, 2), (640, 1024, 3, 512, 128, 2, 3),
    (768, 2048, 5, 1024, 256, 1, 1)])
def test_gram_rows_kernel_matches_plain(card, S, rows, n_limbs, kt, tile,
                                        nrt, rt0):
    rng = np.random.default_rng(S + n_limbs)
    Bp = rng.integers(0, 256, size=(rows // 8, S), dtype=np.uint8)
    w = _u32(rng, rows) >> np.uint32(max(0, 32 - 7 * n_limbs))
    Bt, wt, Ct = gram.from_jax_layout(Bp, gram.pk_weight_order(w, kt),
                                      _u32(rng, (nrt * tile, S)), card)
    n = gram.gram_u32_pk_rows.launches
    plain = gram.gram_u32_pk_rows_plain(Bt, wt, Ct.clone(), rt0,
                                        n_limbs=n_limbs, kt=kt, tile=tile)
    gram.gram_u32_pk_rows(Bt, wt, Ct, rt0, n_limbs=n_limbs, kt=kt, tile=tile)
    torch.cuda.synchronize()
    assert gram.gram_u32_pk_rows.launches == n + 1
    assert torch.equal(Ct, plain)


def _edge_stripe(rng, shape, card):
    edges = np.array([0, 1, 32767, 32768, 65535, 65536, 2**31 - 1, 2**31,
                      2**32 - 1], dtype=np.uint32)
    C = _u32(rng, shape)
    mask = rng.random(shape) < 0.3
    C[mask] = rng.choice(edges, size=int(mask.sum()))
    return torch.from_numpy(C.view(np.int32)).to(card)


def test_cast_rows_kernel_matches_plain(card):
    C = _edge_stripe(np.random.default_rng(12), (384, 640), card)
    n = gram.cast_rows.launches
    got = gram.cast_rows(C)
    torch.cuda.synchronize()
    assert gram.cast_rows.launches == n + 1
    assert torch.equal(got, gram.cast_rows_plain(C))


@pytest.mark.parametrize("lo,hi", [(1, 2**32 - 1), (30, 40000),
                                   (2**31 + 3, 2**32 - 2), (2**31, 2**31)])
def test_filter_colsum_kernel_matches_plain(card, lo, hi):
    C = _edge_stripe(np.random.default_rng(13), (256, 384), card)
    b = gram.bias_bounds(lo, hi)
    n = gram.filter_colsum.launches
    got = gram.filter_colsum(C, b)
    torch.cuda.synchronize()
    assert gram.filter_colsum.launches == n + 1
    assert torch.equal(got, gram.filter_colsum_plain(C, b))


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_gather_tiles_kernel_matches_plain(card, dtype):
    C = _edge_stripe(np.random.default_rng(14), (384, 640), card)
    it, jt = gram.tile_tables([2, 0, 2, 1, 0, 2, 1], [4, 0, 4, 1, 3, 0, 2],
                              card)
    n = gram.gather_tiles.launches
    got = gram.gather_tiles(C, it, jt, dtype)
    torch.cuda.synchronize()
    assert gram.gather_tiles.launches == n + 1
    assert torch.equal(got, gram.gather_tiles_plain(C, it, jt, dtype))


def test_stripe_operands_are_refused(card):
    C = torch.zeros(256 * 256 + 1, dtype=torch.int32, device=card)[1:]
    with pytest.raises(ValueError, match="aligned"):
        gram.cast_rows(C.view(256, 256))
    good = torch.zeros((256, 256), dtype=torch.int32, device=card)
    it, jt = gram.tile_tables([0, 2], [0, 0], card)
    with pytest.raises(ValueError, match="outside"):
        gram.gather_tiles(good, it, jt)
    with pytest.raises(ValueError, match="int32"):
        gram.gather_tiles(good, it.long(), jt.long())
    with pytest.raises(ValueError, match="int32"):
        gram.cast_rows(good.to(torch.int64))


@pytest.mark.skipif(not native.available, reason="no native host runtime")
@pytest.mark.parametrize("resident_mb", ["4096", "0"])
@pytest.mark.parametrize("max_w", [1 << 20, 40])
def test_all2all_device_rows_matches_host_tier(card, monkeypatch,
                                               resident_mb, max_w):
    """Resident and re-packed groups; the uint16 (max_w 40: every count
    below 2^16) and uint32 pulls; dense and survivor-tile pulls."""
    monkeypatch.setenv("KMERDB_A2A_RESIDENT_MB", resident_mb)
    db, host = _random_db(S=300, max_w=max_w)
    lo = int(host[np.tril_indices(300, -1)].max())
    for bounds in (None, (1, 2**32 - 1), (lo, 2**32 - 1)):
        want = host if bounds is None else \
            np.where((host >= bounds[0]) & (host <= bounds[1]), host, 0)
        rows = []
        device_a2a.all2all_device_rows(
            db, lambda i, r: rows.append(r.copy()), stripe_rows=256,
            cell_bounds=bounds)
        np.testing.assert_array_equal(np.stack(rows), want)
        st = device_a2a.last_stats
        assert st["device"] == "cuda" and st["gram_s"] > 0
        assert st["resident_groups"] == (resident_mb != "0")
        if bounds is not None and bounds[0] == lo:
            sp = st["sparse_pull"]
            assert 0 < sp["tiles_pulled"] < sp["tiles_total"]


@pytest.mark.parametrize("Q,P,S,wide,n_limbs", [
    (128, 512, 256, False, 1), (256, 1024, 384, True, 3),
    (128, 384, 128, True, 4)])
def test_matmul_acc_kernel_matches_plain(card, Q, P, S, wide, n_limbs):
    """uint8 H over every byte 0..255 (the unsigned dp4a), uint32 H of 3
    and of 4 limbs at 2^31 and above; C seeded non-zero."""
    rng = np.random.default_rng(Q + P + S)
    B = torch.from_numpy((rng.random((P, S)) < 0.3).astype(np.int8)).to(card)
    if wide:
        lo = 1 << 31 if n_limbs == 4 else 0
        H = rng.integers(lo, 1 << (8 * n_limbs), size=(Q, P),
                         dtype=np.uint64).astype(np.uint32).view(np.int32)
    else:
        H = rng.integers(0, 256, size=(Q, P), dtype=np.uint8)
        H[0, :256] = np.arange(256)
    H = torch.from_numpy(H).to(card)
    C = torch.from_numpy(_u32(rng, (Q, S)).view(np.int32)).to(card)
    n = gram.matmul_u32_acc.launches
    plain = gram.matmul_u32_acc_plain(H, B, C.clone(), n_limbs=n_limbs)
    gram.matmul_u32_acc(H, B, C, n_limbs=n_limbs)
    torch.cuda.synchronize()
    assert gram.matmul_u32_acc.launches == n + 1
    assert torch.equal(C, plain)


@pytest.mark.parametrize("S1,S2,rows,n_limbs,kt", [
    (128, 256, 1024, 3, 512), (384, 128, 2048, 1, 256),
    (256, 640, 1024, 5, 1024)])
def test_cross_kernel_matches_plain(card, S1, S2, rows, n_limbs, kt):
    rng = np.random.default_rng(S1 + S2 + n_limbs)
    Up = torch.from_numpy(rng.integers(0, 256, size=(rows // 8, S1),
                                       dtype=np.uint8)).to(card)
    Vp = torch.from_numpy(rng.integers(0, 256, size=(rows // 8, S2),
                                       dtype=np.uint8)).to(card)
    w = _u32(rng, rows) >> np.uint32(max(0, 32 - 7 * n_limbs))
    w = torch.from_numpy(gram.pk_weight_order(w, kt).view(np.int32)).to(card)
    C = torch.from_numpy(_u32(rng, (S1, S2)).view(np.int32)).to(card)
    n = gram.cross_u32_pk.launches
    plain = gram.cross_u32_pk_plain(Up, Vp, w, C.clone(), n_limbs=n_limbs,
                                    kt=kt)
    gram.cross_u32_pk(Up, Vp, w, C, n_limbs=n_limbs, kt=kt)
    torch.cuda.synchronize()
    assert gram.cross_u32_pk.launches == n + 1
    assert torch.equal(C, plain)


def _built_db(rng, n, pool, core):
    from kmerdb_tpu.models import builder
    samples = [(f"s{i}", np.unique(np.concatenate([core, rng.choice(
        pool, size=int(rng.integers(100, 600)), replace=False)])))
        for i in range(n)]
    return builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        samples)


@pytest.mark.skipif(not native.available, reason="no native host runtime")
def test_query_and_cross_tiers_match_host_tiers(card, monkeypatch):
    """new2all (uint16-range and 2-limb hit counts), db2db (a 17,000 k-mer
    core: three 7-bit limbs) and both device grids on the card, against
    the host tiers."""
    from kmerdb_tpu_torch.ops import fused, intersect
    rng = np.random.default_rng(21)
    pool = rng.integers(0, 1 << 40, size=20_000, dtype=np.uint64)
    core = np.unique(pool[:17_000])
    dbs = [_built_db(rng, n, pool[17_000:], core) for n in (130, 70, 200)]
    queries = [np.unique(rng.choice(pool, size=int(rng.integers(50, 18_000)),
                                    replace=False)) for _ in range(140)]
    queries[3] = np.empty(0, dtype=np.uint64)
    host = intersect.many2all_counts(dbs[0], queries, use_device=False)
    n = gram.matmul_u32_acc.launches
    got = intersect.many2all_counts(dbs[0], queries, use_device=True)
    assert gram.matmul_u32_acc.launches > n
    np.testing.assert_array_equal(got, host)

    monkeypatch.setenv("KMERDB_D2D_DEVICE", "1")
    n = gram.cross_u32_pk.launches
    d2d = {(i, j): intersect.db2db_counts(dbs[i], dbs[j])
           for i in range(3) for j in range(i)}
    assert gram.cross_u32_pk.launches > n
    monkeypatch.setenv("KMERDB_D2D_DEVICE", "0")
    for (i, j), X in d2d.items():
        np.testing.assert_array_equal(X, intersect.db2db_counts(dbs[i],
                                                                dbs[j]))
    assert max(int(X.max()) for X in d2d.values()) >= 1 << 14

    diag = [native.a2a_dense(db.pattern_offsets, db.pattern_sample_ids,
                             db.pattern_num_kmers, db.n_samples)
            for db in dbs]
    grid = fused.grid_group_counts(dbs)
    streamed = dict(fused.grid_rows_streamed(
        lambda i: dbs[i], [db.n_samples for db in dbs],
        max_count=int(max(db.sample_kmer_counts.max() for db in dbs))))
    for i in range(3):
        np.testing.assert_array_equal(grid[i, i], diag[i])
        np.testing.assert_array_equal(streamed[i][i], diag[i])
        for j in range(i):
            np.testing.assert_array_equal(grid[i, j], d2d[i, j])
            np.testing.assert_array_equal(streamed[i][j], d2d[i, j])
