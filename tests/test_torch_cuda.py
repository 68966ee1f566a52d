"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs a CUDA card and nvcc, carries the ``cuda`` marker
and skips elsewhere.  The file imports no jax (the machine with the card
has none), so it runs there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import re

import numpy as np
import pytest
import torch

from kmerdb_tpu_torch.models.database import KmerPatternDb
from kmerdb_tpu_torch.ops import _cuda, device_a2a, gram, sweep
from kmerdb_tpu_torch.utils import native

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape,
                        dtype=np.uint64).astype(np.uint32)


def _ids(cases):
    """The cases' ids, "-ones" after those with every bit and limb set."""
    return ["-".join(map(str, c[:-1])) + ("-ones" if c[-1] else "")
            for c in cases]


def _packed(rng, shape, n_limbs, ones):
    """(packed operand, its weights): random bits and distinct random
    weights of n_limbs 7-bit limbs, or every bit set and every limb 127
    (the top limb of 5 holds the 4 bits left of 32): the largest products
    of the int8 body."""
    if ones:
        return (np.full(shape, 255, np.uint8),
                np.full(8 * shape[0], (1 << min(32, 7 * n_limbs)) - 1,
                        np.uint64).astype(np.uint32))
    Bp = rng.integers(0, 256, size=shape, dtype=np.uint8)
    return Bp, _u32(rng, 8 * shape[0]) >> np.uint32(max(0, 32 - 7 * n_limbs))


#: kt 128 (one stage a K block), S an odd multiple of 128, 2 and 4 limbs of
#: distinct weights (the limb order), and every bit and limb set at 1, 2 and
#: 5 limbs (the largest products; counts past 2^31)
GRAM_CASES = [
    (256, 1024, 1, 256, 128, False), (640, 2048, 5, 1024, 128, False),
    (1024, 2048, 3, 512, 512, False), (384, 1024, 1, 128, 128, True),
    (256, 2048, 2, 512, 256, True), (640, 1024, 5, 128, 128, True),
    (384, 2048, 2, 128, 128, False), (640, 1024, 4, 256, 128, False)]


@pytest.mark.parametrize("S,rows,n_limbs,kt,tile,ones", GRAM_CASES,
                         ids=_ids(GRAM_CASES))
def test_gram_kernel_matches_plain(card, S, rows, n_limbs, kt, tile, ones):
    rng = np.random.default_rng(S + n_limbs)
    Bp, w = _packed(rng, (rows // 8, S), n_limbs, ones)
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


@pytest.mark.parametrize("nt", [1, 2, 33])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_tril_kernel_edges_match_plain(card, nt, dtype):
    """One tile, two, and 33 (561 tiles, past a triangle number where the
    float square root of tri_coords can be off), every cell >= 2^31."""
    rng = np.random.default_rng(nt)
    C = _u32(rng, (128 * nt, 128 * nt)) | np.uint32(1 << 31)
    C = torch.from_numpy(C.view(np.int32)).to(card)
    got = gram.tril_tiles(C, dtype)
    torch.cuda.synchronize()
    assert got.shape == (nt * (nt + 1) // 2, 128, 128)
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


ROWS_CASES = [
    (384, 1024, 1, 256, 128, 1, 2, False),
    (640, 1024, 3, 512, 128, 2, 3, False),
    (768, 2048, 5, 1024, 256, 1, 1, False),
    (384, 1024, 1, 128, 128, 1, 1, True),
    (640, 2048, 2, 256, 128, 2, 2, False),
    (640, 1024, 5, 512, 128, 1, 4, True),
    (384, 1024, 4, 128, 128, 3, 0, False),
    (640, 2048, 2, 128, 128, 1, 0, True)]


@pytest.mark.parametrize("S,rows,n_limbs,kt,tile,nrt,rt0,ones", ROWS_CASES,
                         ids=_ids(ROWS_CASES))
def test_gram_rows_kernel_matches_plain(card, S, rows, n_limbs, kt, tile,
                                        nrt, rt0, ones):
    rng = np.random.default_rng(S + n_limbs)
    Bp, w = _packed(rng, (rows // 8, S), n_limbs, ones)
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


def _gather_checked(C, it, jt, dtype, launches=1):
    """gather_tiles on host tables == its plain version, with `launches`
    counted."""
    n = gram.gather_tiles.launches
    got = gram.gather_tiles(C, it, jt, dtype)
    torch.cuda.synchronize()
    assert gram.gather_tiles.launches == n + launches
    assert got.shape == (len(it), 128, 128) and got.dtype == dtype
    assert torch.equal(got, gram.gather_tiles_plain(C, it, jt, dtype))


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_gather_tiles_kernel_matches_plain(card, dtype):
    C = _edge_stripe(np.random.default_rng(14), (384, 640), card)
    it, jt = gram.tile_tables([2, 0, 2, 1, 0, 2, 1], [4, 0, 4, 1, 3, 0, 2],
                              "cpu")
    _gather_checked(C, it, jt, dtype)


@pytest.mark.parametrize("case", ["one", "every", "row_stride", "chunked"])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
def test_gather_tiles_kernel_shapes_match_plain(card, case, dtype):
    """n = 1; every tile of a (384, 640) stripe with repeats, out of order
    (numpy tables); a window of a wider stripe (rows 1,024 cells apart,
    640 wide); more tiles than one launch holds (two launches)."""
    rng = np.random.default_rng(15)
    C = _edge_stripe(rng, (384, 640), card)
    cap = _cuda.lib().kmerdb_gather_capacity()
    assert cap == gram.GATHER_CAPACITY     # the wrapper counts by its own
    launches = 1
    if case == "one":
        it, jt = np.array([2], np.int32), np.array([3], np.int32)
    elif case == "every":
        flat = np.concatenate([rng.permutation(15), rng.integers(0, 15, 9)])
        it, jt = (flat // 5).astype(np.int32), (flat % 5).astype(np.int32)
    elif case == "row_stride":
        C = _edge_stripe(rng, (384, 1024), card)[:, 256:896]
        assert C.stride(0) == 1024
        it, jt = np.array([0, 2, 1, 2], np.int32), np.array([4, 0, 3, 4],
                                                            np.int32)
    else:
        flat = rng.integers(0, 15, cap + 100)
        it, jt = (flat // 5).astype(np.int32), (flat % 5).astype(np.int32)
        launches = 2
    _gather_checked(C, it, jt, dtype, launches)


def test_gather_tiles_does_not_synchronise(card):
    """No device-to-host read and no blocking copy: the call passes under
    torch's sync debug mode set to raise."""
    C = _edge_stripe(np.random.default_rng(16), (384, 640), card)
    it, jt = np.array([2, 0, 1], np.int32), np.array([4, 0, 3], np.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = gram.gather_tiles(C, it, jt, torch.int16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, gram.gather_tiles_plain(C, it, jt, torch.int16))


def test_stripe_operands_are_refused(card):
    C = torch.zeros(256 * 256 + 1, dtype=torch.int32, device=card)[1:]
    with pytest.raises(ValueError, match="aligned"):
        gram.cast_rows(C.view(256, 256))
    good = torch.zeros((256, 256), dtype=torch.int32, device=card)
    it, jt = gram.tile_tables([0, 2], [0, 0], "cpu")
    n = gram.gather_tiles.launches
    with pytest.raises(ValueError, match="outside"):
        gram.gather_tiles(good, it, jt)
    with pytest.raises(ValueError, match="outside"):
        gram.gather_tiles(good, np.array([0], np.int32),
                          np.array([-1], np.int32))
    assert gram.gather_tiles.launches == n
    with pytest.raises(ValueError, match="int32"):
        gram.gather_tiles(good, it.long(), jt.long())
    with pytest.raises(ValueError, match="i_tab and j_tab .* not on cuda"):
        gram.gather_tiles(good, *gram.tile_tables([0], [0], card))
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
    """uint8 H over every byte 0..255 (the .u8 mma), uint32 H of 3 and of 4
    limbs at 2^31 and above; C seeded non-zero."""
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


#: the last case sums 2^24 + 1024 patterns of weight 127: past the block's
#: flush of 2^24 patterns, and every count past 2^31
CROSS_CASES = [
    (128, 256, 1024, 3, 512, False), (384, 128, 2048, 1, 256, False),
    (256, 640, 1024, 5, 1024, False), (384, 640, 1024, 2, 128, False),
    (640, 384, 2048, 4, 256, False), (128, 384, 1024, 1, 512, True),
    (384, 128, 1024, 5, 128, True),
    (128, 256, (1 << 24) + 1024, 1, 1024, True)]


@pytest.mark.parametrize("S1,S2,rows,n_limbs,kt,ones", CROSS_CASES,
                         ids=_ids(CROSS_CASES))
def test_cross_kernel_matches_plain(card, S1, S2, rows, n_limbs, kt, ones):
    rng = np.random.default_rng(S1 + S2 + n_limbs)
    Up, w = _packed(rng, (rows // 8, S1), n_limbs, ones)
    Vp, _ = _packed(rng, (rows // 8, S2), n_limbs, ones)
    Up, Vp = torch.from_numpy(Up).to(card), torch.from_numpy(Vp).to(card)
    w = torch.from_numpy(gram.pk_weight_order(w, kt).view(np.int32)).to(card)
    C = torch.from_numpy(_u32(rng, (S1, S2)).view(np.int32)).to(card)
    n = gram.cross_u32_pk.launches
    plain = gram.cross_u32_pk_plain(Up, Vp, w, C.clone(), n_limbs=n_limbs,
                                    kt=kt)
    gram.cross_u32_pk(Up, Vp, w, C, n_limbs=n_limbs, kt=kt)
    torch.cuda.synchronize()
    assert gram.cross_u32_pk.launches == n + 1
    assert torch.equal(C, plain)


def _bf16_weights(rng, rows, wbits):
    """Distinct random weights below 2^wbits, a quarter of them with every
    limb byte in 129..255 (K-block partials that are no multiple of 16)."""
    w = rng.integers(0, 1 << wbits, size=rows, dtype=np.uint64)
    q = rng.random(rows) < 0.25
    w[q] = sum(rng.integers(129, 256, size=int(q.sum()), dtype=np.uint64)
               << np.uint64(8 * l) for l in range(-(-wbits // 8)))
    return (w & np.uint64((1 << wbits) - 1)).astype(np.uint32)


def _bf16_form(form, U, V, w, C, plain=False, rt0=0, **kw):
    """One bf16 form (csrc/gram_pk_bf16.cu), or its plain version: the
    triangle and the stripe over U, the rectangle over U and V."""
    kw["engine"] = "bf16"
    if form == "tri":
        fn = gram.gram_u32_pk_tri_plain if plain else gram.gram_u32_pk_tri
        return fn(U, w, C, **kw)
    if form == "rows":
        fn = gram.gram_u32_pk_rows_plain if plain else gram.gram_u32_pk_rows
        return fn(U, w, C, rt0, **kw)
    kw.pop("tile", None)
    fn = gram.cross_u32_pk_plain if plain else gram.cross_u32_pk
    return fn(U, V, w, C, **kw)


_BF16_FNS = {"tri": gram.gram_u32_pk_tri, "rows": gram.gram_u32_pk_rows,
             "cross": gram.cross_u32_pk}

#: (form, S1 or S, S2 or stripe rows, patterns, limbs, weight bits, kt,
#: tile, rt0): distinct weights of 1, 2 and 4 8-bit limbs (22 and 40 bits
#: past their limbs: dropped), kt 256, 512 and 1024, coarse tiles of 256,
#: a stripe other than the first, and rectangles of two pitches (db2db's
#: 1,024 x 3,072); then the edges of the wgmma block: one stage (128
#: patterns, n_st 1) and kt 128 (one stage a K block, a flush every stage)
#: over several K blocks, each form at 1 and 4 limbs
BF16_CASES = [
    ("tri", 384, 384, 1024, 1, 8, 512, 128, 0),
    ("tri", 768, 768, 2048, 4, 32, 1024, 256, 0),
    ("tri", 384, 384, 1024, 2, 22, 256, 128, 0),
    ("rows", 640, 256, 1024, 2, 16, 256, 128, 2),
    ("rows", 768, 256, 2048, 4, 32, 1024, 256, 1),
    ("cross", 1024, 3072, 1024, 2, 16, 512, 128, 0),
    ("cross", 384, 128, 2048, 4, 32, 256, 128, 0),
    ("cross", 128, 640, 1024, 1, 12, 1024, 128, 0),
    ("tri", 256, 256, 128, 1, 8, 128, 128, 0),
    ("rows", 384, 128, 128, 4, 32, 128, 128, 1),
    ("cross", 256, 384, 128, 4, 32, 128, 128, 0),
    ("tri", 512, 512, 1024, 4, 32, 128, 256, 0),
    ("rows", 512, 256, 640, 1, 8, 128, 128, 1),
    ("cross", 384, 256, 896, 2, 16, 128, 128, 0)]


@pytest.mark.parametrize("form,S1,S2,rows,n_limbs,wbits,kt,tile,rt0",
                         BF16_CASES,
                         ids=["-".join(map(str, c)) for c in BF16_CASES])
def test_bf16_gram_kernels_match_plain(card, form, S1, S2, rows, n_limbs,
                                       wbits, kt, tile, rt0):
    """The bf16 engine's forms == their plain versions, C seeded at 2^31
    and above; each launch counts in launches_bf16 and in no s8 counter."""
    rng = np.random.default_rng(S1 + S2 + n_limbs + kt)
    U = torch.from_numpy(rng.integers(0, 256, size=(rows // 8, S1),
                                      dtype=np.uint8)).to(card)
    V = torch.from_numpy(rng.integers(0, 256, size=(rows // 8, S2),
                                      dtype=np.uint8)).to(card) \
        if form == "cross" else None
    w_np = _bf16_weights(rng, rows, min(wbits, 32))
    w = torch.from_numpy(gram.pk_weight_order(w_np, kt).view(np.int32)) \
        .to(card)
    shape = {"tri": (S1, S1), "rows": (S2, S1), "cross": (S1, S2)}[form]
    C = torch.from_numpy((_u32(rng, shape) | np.uint32(1 << 31))
                         .view(np.int32)).to(card)
    kw = dict(n_limbs=n_limbs, kt=kt, tile=tile, rt0=rt0)
    fn = _BF16_FNS[form]
    n, n_s8 = fn.launches_bf16, fn.launches
    want = _bf16_form(form, U, V, w, C.clone(), plain=True, **kw)
    got = _bf16_form(form, U, V, w, C.clone(), **kw)
    torch.cuda.synchronize()
    assert (fn.launches_bf16, fn.launches) == (n + 1, n_s8)
    assert torch.equal(got, want) and not torch.equal(got, C)


@pytest.mark.parametrize("form", ["tri", "rows", "cross"])
def test_bf16_gram_kernels_flush_every_k_block(card, form):
    """Every byte 0xFF and weights drawn from 129..255 at kt 65,536 and P
    131,072: each K block's f32 sum of a cell is at most 255 * 65,536,
    below 2^24, and the cell gains the weights' sum, about 2.5 * 10^7 >
    2^24 and no multiple of a large power of two, which a block that kept
    its f32 sums across K blocks would round.  C seeded at 2^31 and
    above; the rectangle at two pitches."""
    S, P, kt = 256, 131072, 65536
    rng = np.random.default_rng(17)
    U = torch.full((P // 8, S), 255, dtype=torch.uint8, device=card)
    V = torch.full((P // 8, 128), 255, dtype=torch.uint8, device=card)
    w_np = rng.integers(129, 256, size=P, dtype=np.int32)
    w = torch.from_numpy(w_np).to(card)
    shape = {"tri": (S, S), "rows": (128, S), "cross": (S, 128)}[form]
    C = torch.from_numpy((_u32(rng, shape) | np.uint32(1 << 31))
                         .view(np.int32)).to(card)
    kw = dict(n_limbs=1, kt=kt, tile=128, rt0=1)
    want = _bf16_form(form, U, V, w, C.clone(), plain=True, **kw)
    got = _bf16_form(form, U, V, w, C.clone(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    gain = int(w_np.sum())
    assert gain > 1 << 24
    moved = (got.to(torch.int64) - C.to(torch.int64)) & 0xFFFFFFFF
    if form == "tri":
        band = torch.arange(S, device=card) // 128
        lower = band[:, None] >= band[None, :]
        assert bool((moved[lower] == gain).all()) and not moved[~lower].any()
    else:
        assert bool((moved == gain).all())


#: the kernels on gram_bf16.cuh's packed block, which must run wgmma
WGMMA_KERNELS = ("gram_pk_tri_bf16_kernel", "gram_pk_rows_bf16_kernel",
                 "cross_pk_bf16_kernel", "sweep_pk_bf16_kernel")


def test_bf16_packed_block_runs_on_wgmma(card):
    """The SASS of the packed block's kernels (cuobjdump -sass of the
    built library) holds HGMMA and no HMMA or LDSM; nodot's holds its
    cp.async ring (LDGSTS), no product and no single-byte global load;
    block() (dotonly) stays on mma.sync; ptxas spills none of them."""
    _cuda.lib()
    names = (*WGMMA_KERNELS, "sweep_nodot_kernel", "sweep_dot_bf16_kernel")
    ops = _cuda.sass_opcodes(names)

    def has(name, *prefixes):
        return any(op.startswith(prefixes) for op in ops[name])
    for name in WGMMA_KERNELS:
        assert has(name, "HGMMA") and not has(name, "HMMA", "LDSM"), name
    assert has("sweep_nodot_kernel", "LDGSTS")
    assert not has("sweep_nodot_kernel", "HGMMA", "HMMA")
    assert not any(op.startswith("LDG") and ".U8" in op
                   for op in ops["sweep_nodot_kernel"])
    assert has("sweep_dot_bf16_kernel", "HMMA")
    spills, cur = {}, None
    for ln in _cuda.build_log().splitlines():
        if "Compiling entry function" in ln:
            cur = next((n for n in names if n in ln), None)
        elif cur and "spill stores" in ln:
            spills[cur] = spills.get(cur, 0) + sum(
                int(x) for x in re.findall(r"(\d+) bytes spill", ln))
    assert set(spills) == set(names) and not any(spills.values()), spills


def test_bf16_gram_refuses_what_it_cannot_hold(card):
    """n_limbs 5 and 255 * kt >= 2^24 raise ValueError on the card too,
    with nothing launched on another route."""
    Bp = torch.zeros((65920 // 8, 128), dtype=torch.uint8, device=card)
    w = torch.zeros(65920, dtype=torch.int32, device=card)
    C = torch.zeros((128, 128), dtype=torch.int32, device=card)
    n = (gram.gram_u32_pk_tri.launches, gram.gram_u32_pk_tri.launches_bf16)
    for kw in (dict(n_limbs=5, kt=128), dict(n_limbs=1, kt=65920)):
        with pytest.raises(ValueError):
            gram.gram_u32_pk_tri(Bp, w, C, engine="bf16", **kw)
    assert (gram.gram_u32_pk_tri.launches,
            gram.gram_u32_pk_tri.launches_bf16) == n


def _built_db(rng, n, pool, core):
    from kmerdb_tpu_torch.models import builder
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


GRAM_U32_CASES = [
    (512, 384, 1, True, "random"), (384, 256, 4, False, "random"),
    (1024, 640, 3, True, "random"), (256, 128, 2, False, "random"),
    (512, 384, 1, True, "ones"), (384, 256, 4, False, "ones"),
    ((1 << 23) + (1 << 16), 128, 1, True, "long")]


@pytest.mark.parametrize(
    "P,S,n_limbs,triangle,operands", GRAM_U32_CASES,
    ids=[f"{P}-{S}-{n}-{tri}" + ("" if op == "random" else f"-{op}")
         for P, S, n, tri, op in GRAM_U32_CASES])
def test_gram_u32_kernels_match_plain(card, P, S, n_limbs, triangle,
                                      operands):
    """Weights over every bit with 255, 2^8 and 2^31 among them: the limbs
    above n_limbs are dropped, limb bytes reach 255 (read as .u8).  "ones":
    B all ones and every weight 2^32 - 1, so every limb byte is 255, the
    largest products.  "long": 2^23 + 2^16 patterns of ones at weight
    2^32 - 1 and one 8-bit limb, whose s32 sum (255 per pattern) would pass
    2^31 without the flush every 2^23 patterns; every cell is P * 255 mod
    2^32 (the plain version is not run at this 1.08 GB size)."""
    rng = np.random.default_rng(P + S + n_limbs)
    kern = gram.gram_u32_tri if triangle else gram.gram_u32
    plain = gram.gram_u32_tri_plain if triangle else gram.gram_u32_plain
    if operands == "random":
        B = torch.from_numpy((rng.random((P, S)) < 0.3).astype(np.int8)) \
            .to(card)
        w = _u32(rng, P)
        w[:3] = (255, 256, 1 << 31)
        w = torch.from_numpy(w.view(np.int32)).to(card)
    else:
        B = torch.ones((P, S), dtype=torch.int8, device=card)
        w = torch.full((P,), -1, dtype=torch.int32, device=card)
    n = kern.launches
    got = kern(B, w, n_limbs=n_limbs)
    torch.cuda.synchronize()
    assert kern.launches == n + 1
    if operands == "long":
        assert P * 255 > 1 << 31
        want = int(np.uint32(P * 255 % (1 << 32)).view(np.int32))
        assert torch.equal(got, torch.full_like(got, want))
        return
    assert torch.equal(got, plain(B, w, n_limbs=n_limbs)) and bool(got.any())


@pytest.mark.parametrize("Q,P,S,wide,n_limbs", [
    (128, 512, 256, False, 1), (256, 384, 384, True, 4),
    (128, 256, 128, True, 2)])
def test_matmul_u32_kernel_matches_plain(card, Q, P, S, wide, n_limbs):
    """uint8 H over every byte; uint32 H over every bit (4 limbs: 2^31 and
    above; 2 limbs: the bits above dropped)."""
    rng = np.random.default_rng(Q + P + S + n_limbs)
    B = torch.from_numpy((rng.random((P, S)) < 0.3).astype(np.int8)).to(card)
    if wide:
        H = _u32(rng, (Q, P)).view(np.int32)
    else:
        H = rng.integers(0, 256, size=(Q, P), dtype=np.uint8)
        H[0, :256] = np.arange(256)
    H = torch.from_numpy(H).to(card)
    n = gram.matmul_u32.launches
    got = gram.matmul_u32(H, B, n_limbs=n_limbs)
    torch.cuda.synchronize()
    assert gram.matmul_u32.launches == n + 1
    assert torch.equal(got, gram.matmul_u32_plain(H, B, n_limbs=n_limbs))


def _matmul_operands(card, rng, Q, P, S, n_limbs):
    """0/1 B, H over every byte (uint8) or of n_limbs limbs at its top
    bit and above (uint32), C seeded at 2^31 and above."""
    B = torch.from_numpy((rng.random((P, S)) < 0.3).astype(np.int8)).to(card)
    if n_limbs == 1:
        H = rng.integers(0, 256, size=(Q, P), dtype=np.uint8)
        H[0, :256] = np.arange(256)
    else:
        H = rng.integers(1 << (8 * n_limbs - 1), 1 << (8 * n_limbs),
                         size=(Q, P), dtype=np.uint64)
        H = H.astype(np.uint32).view(np.int32)
    C = _u32(rng, (Q, S)) | np.uint32(1 << 31)
    return (torch.from_numpy(H).to(card), B,
            torch.from_numpy(C.view(np.int32)).to(card))


#: (Q, P, S, n_limbs, k_splits): the 76-query flush and a mesh slot (Q_pad
#: 128) against the scale database's chunk at the planner's split (None);
#: uneven splits (5 and 82 stages); 2 and 3 limbs over several splits
MATMUL_SPLIT_CASES = [
    (128, 10_496, 4096, 1, None), (128, 640, 256, 1, 3),
    (256, 10_496, 384, 1, 5), (128, 1024, 512, 2, 3),
    (256, 1536, 256, 3, 7)]


@pytest.mark.parametrize("Q,P,S,n_limbs,k_splits", MATMUL_SPLIT_CASES)
def test_matmul_split_k_matches_plain(card, Q, P, S, n_limbs, k_splits):
    """matmul_u32_acc and matmul_u32 over a split-K grid (red.global.add
    into C) equal their plain versions exactly."""
    rng = np.random.default_rng(Q + P + S + n_limbs)
    H, B, C = _matmul_operands(card, rng, Q, P, S, n_limbs)
    planned = gram.matmul_splits(
        Q, S, P, torch.cuda.get_device_properties(card).multi_processor_count)
    assert (k_splits or planned) > 1
    n = gram.matmul_u32_acc.launches, gram.matmul_u32.launches
    plain = gram.matmul_u32_acc_plain(H, B, C.clone(), n_limbs=n_limbs)
    gram.matmul_u32_acc(H, B, C, n_limbs=n_limbs, k_splits=k_splits)
    fresh = gram.matmul_u32(H, B, n_limbs=n_limbs, k_splits=k_splits)
    torch.cuda.synchronize()
    assert (gram.matmul_u32_acc.launches, gram.matmul_u32.launches) == \
        (n[0] + 1, n[1] + 1)
    assert torch.equal(C, plain)
    assert torch.equal(fresh, gram.matmul_u32_plain(H, B, n_limbs=n_limbs))


def test_matmul_past_the_flush(card):
    """2^23 + 2^16 patterns of H byte 255 against an all-ones B in one
    split: past the block's flush of 2^23 patterns, and every count, 255 P
    mod 2^32, past 2^31 (255 (2^23 + 256) is not)."""
    P = (1 << 23) + (1 << 16)
    H = torch.full((128, P), 255, dtype=torch.uint8, device=card)
    B = torch.ones((P, 128), dtype=torch.int8, device=card)
    C = torch.zeros((128, 128), dtype=torch.int32, device=card)
    gram.matmul_u32_acc(H, B, C, n_limbs=1, k_splits=1)
    torch.cuda.synchronize()
    assert P * 255 > 1 << 31
    want = int(np.uint32(P * 255 % (1 << 32)).view(np.int32))
    assert torch.equal(C, torch.full_like(C, want))


@pytest.mark.parametrize("n_limbs", [1, 2, 3, 4])
def test_limb_planes_kernel_matches_plain(card, n_limbs):
    """Words at 2^31 and above, and every byte value in each limb."""
    rng = np.random.default_rng(40 + n_limbs)
    H = _u32(rng, (256, 384)) | np.uint32(1 << 31)
    H[0, :256] = np.arange(256, dtype=np.uint32) * 0x01010101
    H = torch.from_numpy(H.view(np.int32)).to(card)
    n = gram.limb_planes.launches
    got = gram.limb_planes(H, n_limbs)
    torch.cuda.synchronize()
    assert gram.limb_planes.launches == n + 1
    assert torch.equal(got, gram.limb_planes_plain(H, n_limbs))


@pytest.mark.skipif(not native.available, reason="no native host runtime")
def test_scan_tiers_match_host_tiers(card, monkeypatch):
    """all2all's scan on both grids over several chunks, and new2all's scan
    with 2-limb hit counts, against the host tiers."""
    from kmerdb_tpu_torch.ops import intersect
    monkeypatch.setenv("KMERDB_A2A_PALLAS", "0")
    monkeypatch.setattr(intersect, "_CHUNK_E", 20_000)
    db, host = _random_db()
    for triangle in (True, False):
        np.testing.assert_array_equal(
            intersect._a2a_scan(db, triangle=triangle), host)
    assert intersect.scan_stats["chunks"] > 2
    assert intersect.scan_stats["gram_s"] > 0

    rng = np.random.default_rng(22)
    pool = rng.integers(0, 1 << 40, size=5_000, dtype=np.uint64)
    core = np.unique(pool[:600])
    qdb = _built_db(rng, 150, pool[600:], core)
    queries = [np.unique(rng.choice(pool, size=int(rng.integers(50, 4_000)),
                                    replace=False)) for _ in range(130)]
    want = intersect.many2all_counts(qdb, queries, use_device=False)
    n = gram.matmul_u32.launches
    got = intersect.many2all_counts(qdb, queries, use_device=True)
    assert gram.matmul_u32.launches > n
    assert intersect.n2a_stats["n_limbs"] == 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("R,S", [(1536, 20480), (128, 128)])
@pytest.mark.parametrize("lo,hi", [(1, 2**32 - 1), (30, 40000),
                                   (2**31 - 5, 2**31 + 5), (2**31, 2**31)])
def test_bounds_zero_rows_kernel_matches_plain(card, lo, hi, R, S, dtype):
    """The streamed route's stripe and the smallest one; bounds on both
    sides of 2^31, where the int32 storage is negative."""
    C = _edge_stripe(np.random.default_rng(15), (R, S), card)
    b = gram.bias_bounds(lo, hi)
    n = gram.bounds_zero_rows.launches
    got = gram.bounds_zero_rows(C, b, dtype)
    torch.cuda.synchronize()
    assert gram.bounds_zero_rows.launches == n + 1
    assert got.dtype == dtype
    assert torch.equal(got, gram.bounds_zero_rows_plain(C, b, dtype))
    # counted at uint32: a survivor at 2^31 narrows to 0
    kept = int(torch.count_nonzero(gram.bounds_zero_rows_plain(C, b)))
    assert 0 < kept < C.numel()


def test_bounds_zero_rows_operands_are_refused(card):
    C = torch.zeros(256 * 256 + 1, dtype=torch.int32, device=card)[1:]
    with pytest.raises(ValueError, match="aligned"):
        gram.bounds_zero_rows(C.view(256, 256), gram.bias_bounds(1, 9))


def _card_mesh(n=4):
    """A mesh of n slots, each with its own stream, on the one card."""
    from kmerdb_tpu_torch.parallel.mesh import Mesh
    return Mesh([torch.device("cuda", 0)] * n)


@pytest.mark.skipif(not native.available, reason="no native host runtime")
@pytest.mark.parametrize("resident_mb", ["4096", "0"])
@pytest.mark.parametrize("max_w", [1 << 20, 40])
def test_rows_sharded_on_one_card_matches_host_tier(card, monkeypatch,
                                                    resident_mb, max_w):
    """Four slots of the card own row stripes: the uint16 (max_w 40) and
    uint32 pulls, dense (cast_rows) and with count bounds
    (bounds_zero_rows), resident and re-packed groups, the last round
    clamped; each case twice (a missing stream dependency would differ)."""
    from kmerdb_tpu_torch.parallel import sharded
    monkeypatch.setenv("KMERDB_A2A_RESIDENT_MB", resident_mb)
    db, host = _random_db(S=700, P=6000, max_w=max_w)
    lo = int(host[np.tril_indices(700, -1)].max()) // 2
    for bounds in (None, (1, 2**32 - 1), (lo, 2**32 - 1)):
        want = host if bounds is None else \
            np.where((host >= bounds[0]) & (host <= bounds[1]), host, 0)
        for _ in range(2):
            launched = gram.gram_u32_pk_rows.launches, \
                gram.bounds_zero_rows.launches, gram.cast_rows.launches
            rows, order = [], []
            sharded.all2all_rows_sharded(
                db, _card_mesh(4), lambda i, r: (order.append(i),
                                                 rows.append(r.copy())),
                stripe_rows=128, cell_bounds=bounds)
            assert order == list(range(700))
            np.testing.assert_array_equal(np.stack(rows), want)
            st = sharded.last_stats
            assert st["slots"] == 4 and st["devices"] == 1
            assert st["rounds"] == 2 and st["gram_s"] > 0
            assert st["resident_groups"] == (resident_mb != "0")
            n_rows, n_zero, n_cast = (
                gram.gram_u32_pk_rows.launches - launched[0],
                gram.bounds_zero_rows.launches - launched[1],
                gram.cast_rows.launches - launched[2])
            assert n_rows == 8 * st["groups"]
            assert n_zero == (8 if bounds is not None else 0)
            assert n_cast == (8 if bounds is None and st["narrow"] else 0)


def _check_sharded_counts(make_mesh, monkeypatch):
    """all2all, new2all and db2db over make_mesh() against the host tiers,
    each twice, with the launches their plans come to."""
    from kmerdb_tpu_torch.ops import intersect
    from kmerdb_tpu_torch.parallel import sharded
    rng = np.random.default_rng(21)
    pool = rng.integers(0, 1 << 40, size=20_000, dtype=np.uint64)
    core = np.unique(pool[:17_000])
    dbs = [_built_db(rng, n, pool[17_000:], core) for n in (130, 70)]
    queries = [np.unique(rng.choice(pool, size=int(rng.integers(50, 18_000)),
                                    replace=False)) for _ in range(140)]
    monkeypatch.setattr(intersect, "_CHUNK_E", 4096)    # many chunks a slot
    a2a_host = native.a2a_dense(dbs[0].pattern_offsets,
                                dbs[0].pattern_sample_ids,
                                dbs[0].pattern_num_kmers, dbs[0].n_samples)
    m2a_host = intersect.many2all_counts(dbs[0], queries, use_device=False)
    monkeypatch.setenv("KMERDB_D2D_DEVICE", "0")
    d2d_host = intersect.db2db_counts(dbs[0], dbs[1])
    assert int(d2d_host.max()) >= 1 << 14
    for _ in range(2):
        n = (gram.gram_u32_tri.launches, gram.matmul_u32_acc.launches,
             gram.cross_u32_pk.launches)
        mesh = make_mesh()
        intersect.scan_stats.clear()
        sharded.plan_stats.clear()
        np.testing.assert_array_equal(
            sharded.all2all_counts_sharded(dbs[0], mesh), a2a_host)
        np.testing.assert_array_equal(
            sharded.many2all_counts_sharded(dbs[0], queries, mesh), m2a_host)
        np.testing.assert_array_equal(
            sharded.db2db_counts_sharded(dbs[0], dbs[1], mesh), d2d_host)
        plan = sharded.plan_stats
        assert intersect.scan_stats["chunks"] >= mesh.size
        assert plan["m2a_chunks"] >= 1 and plan["d2d_shares"] == mesh.size
        assert gram.gram_u32_tri.launches \
            == n[0] + intersect.scan_stats["chunks"]
        assert gram.matmul_u32_acc.launches \
            == n[1] + plan["m2a_chunks"] * mesh.size
        assert gram.cross_u32_pk.launches == n[2] + plan["d2d_launches"]


@pytest.mark.skipif(not native.available, reason="no native host runtime")
def test_sharded_counts_on_one_card_match_single_card_tiers(card,
                                                            monkeypatch):
    """Four slots of the one card."""
    _check_sharded_counts(lambda: _card_mesh(4), monkeypatch)


needs_two_cards = pytest.mark.skipif(
    torch.cuda.device_count() < 2,
    reason="a mesh over more than one card needs two CUDA cards")


@needs_two_cards
@pytest.mark.skipif(not native.available, reason="no native host runtime")
def test_sharded_counts_on_two_cards_match_host_tiers(card, monkeypatch):
    """make_mesh(2): one slot a card.  The partial counts cross devices to
    be summed, and new2all's B is replicated on both."""
    from kmerdb_tpu_torch.parallel.mesh import make_mesh
    assert len(make_mesh(2).devices) == 2
    _check_sharded_counts(lambda: make_mesh(2), monkeypatch)


@needs_two_cards
@pytest.mark.skipif(not native.available, reason="no native host runtime")
@pytest.mark.parametrize("resident_mb", ["4096", "0"])
def test_rows_sharded_on_two_cards_matches_host_tier(card, monkeypatch,
                                                     resident_mb):
    """make_mesh(2): the packed groups are copied to the second card, whose
    slot's kernels are timed by events of its own stream; dense and with
    count bounds, each twice."""
    from kmerdb_tpu_torch.parallel import sharded
    from kmerdb_tpu_torch.parallel.mesh import make_mesh
    monkeypatch.setenv("KMERDB_A2A_RESIDENT_MB", resident_mb)
    db, host = _random_db(S=700, P=6000, max_w=40)
    lo = int(host[np.tril_indices(700, -1)].max()) // 2
    for bounds in (None, (lo, 2**32 - 1)):
        want = host if bounds is None else \
            np.where((host >= bounds[0]) & (host <= bounds[1]), host, 0)
        for _ in range(2):
            rows, order = [], []
            sharded.all2all_rows_sharded(
                db, make_mesh(2), lambda i, r: (order.append(i),
                                                rows.append(r.copy())),
                stripe_rows=128, cell_bounds=bounds)
            assert order == list(range(700))
            np.testing.assert_array_equal(np.stack(rows), want)
            st = sharded.last_stats
            assert st["slots"] == 2 and st["devices"] == 2
            assert st["rounds"] == 3 and st["gram_s"] > 0


SWEEP_CASES = [(512, 128, 512, "random"), (1024, 256, 512, "random"),
               (128, 128, 384, "random"), (128, 128, 640, "ones")]
#: every variant at every case, dotonly_s8 on signed operands, and dotonly
#: and dotonly_T on half-integer ones (each K block's truncation shows)
SWEEP_PARAMS = [(v, *case) for case in SWEEP_CASES for v in sweep.VARIANTS] \
    + [("dotonly_s8", 512, 128, 512, "signed"),
       ("dotonly_s8", 1024, 256, 768, "signed")] \
    + [(v, kt, tile, 512, "halves") for v in sweep.UNPACKED_BF16
       for kt, tile in ((128, 128), (512, 256))]


@pytest.mark.parametrize(
    "variant,kt,tile,S,operands", SWEEP_PARAMS,
    ids=[f"{v}-{kt}-{tile}" + (f"-{S}" if S != 512 else "")
         + ("" if op == "random" else f"-{op}")
         for v, kt, tile, S, op in SWEEP_PARAMS])
def test_sweep_kernels_match_plain(card, variant, kt, tile, S, operands):
    """The kernel sweep's variants (csrc/gram_sweep.cu): Bi != Bj, weights
    of 128, 256 and above (each body masks them), C seeded non-zero; kt
    128 at S 384, and every bit and weight bit set at S 640; dotonly_s8
    over the whole of -128..127 (0/1 operands cannot tell .s8 from .u8),
    -128 * -128 among the products; dotonly and dotonly_T on values in
    {-1, -0.5, 0, 0.5, 1, 1.5}."""
    P = 4096
    rng = np.random.default_rng(kt + len(variant))
    dt = sweep.operand_dtype(variant)
    ones = operands == "ones"
    if variant in sweep.PACKED:
        Bi, Bj = (torch.from_numpy(np.full((P // 8, S), 255, np.uint8) if ones
                                   else rng.integers(0, 256, size=(P // 8, S),
                                                     dtype=np.uint8)).to(card)
                  for _ in range(2))
    elif operands == "halves":
        Bi, Bj = (torch.from_numpy(_halves(rng, (P, S))).to(card)
                  for _ in range(2))
        if variant == "dotonly_T":
            Bi = Bi.T.contiguous()
        Bi, Bj = Bi.to(dt), Bj.to(dt)
    elif operands == "signed":
        Bi, Bj = (rng.integers(-128, 128, size=(P, S), dtype=np.int8)
                  for _ in range(2))
        Bi[:2, :2] = Bj[:2, :2] = -128
        Bi, Bj = torch.from_numpy(Bi).to(card), torch.from_numpy(Bj).to(card)
    else:
        Bi, Bj = (torch.from_numpy(np.ones((P, S), np.int8) if ones
                                   else rng.integers(0, 2, size=(P, S),
                                                     dtype=np.int8)).to(card)
                  for _ in range(2))
        if variant == "dotonly_T":
            Bi = Bi.T.contiguous()
        Bi, Bj = Bi.to(dt), Bj.to(dt)
    w = np.full(P, 0xFFFFFFFF, np.uint32) if ones else _u32(rng, P)
    if not ones:
        w[:4] = (127, 128, 255, 256)
    w = torch.from_numpy(w.view(np.int32)).to(card)
    C = torch.from_numpy(_u32(rng, (S, S)).view(np.int32)).to(card)
    kern = sweep.KERNELS[variant]
    n = kern.launches
    want = sweep.plain(variant, w, Bi, Bj, C.clone(), kt=kt, tile=tile)
    got = kern(w, Bi, Bj, C.clone(), kt=kt, tile=tile)
    torch.cuda.synchronize()
    assert kern.launches == n + 1
    assert torch.equal(got, want) and not torch.equal(got, C)


def _halves(rng, shape):
    return rng.choice(np.array([-1.0, -0.5, 0.0, 0.5, 1.0, 1.5], np.float32),
                      size=shape)


#: (P, kt, k_splits): one K block (no split), 5 K blocks at the planner's
#: split and at 2 and 3 runs (uneven: 3 + 2, 2 + 2 + 1), 7 of 128 at 4
SPLIT_CASES = [(512, 512, None), (5 * 512, 512, None), (5 * 512, 512, 2),
               (5 * 512, 512, 3), (7 * 128, 128, 4)]


@pytest.mark.parametrize("variant", ["dotonly", "dotonly_T"])
@pytest.mark.parametrize("P,kt,k_splits", SPLIT_CASES,
                         ids=[f"{p}-{kt}-{z}" for p, kt, z in SPLIT_CASES])
def test_sweep_dot_split_boundaries(card, variant, P, kt, k_splits):
    """dotonly and dotonly_T on the bf16 tensor cores at the edges of the
    split-K grid: each split a run of whole K blocks, on half-integer
    operands, so that a split inside a K block would move a truncation;
    S 384 at tile 128 (6 output blocks), C seeded non-zero."""
    S = 384
    rng = np.random.default_rng(P + kt)
    Bi, Bj = (torch.from_numpy(_halves(rng, (P, S))).to(card)
              for _ in range(2))
    if variant == "dotonly_T":
        Bi = Bi.T.contiguous()
    Bi, Bj = Bi.to(torch.bfloat16), Bj.to(torch.bfloat16)
    w = torch.zeros(P, dtype=torch.int32, device=card)
    C = torch.from_numpy(_u32(rng, (S, S)).view(np.int32)).to(card)
    kern = sweep.KERNELS[variant]
    n = kern.launches
    want = sweep.plain(variant, w, Bi, Bj, C.clone(), kt=kt, tile=128)
    got = kern(w, Bi, Bj, C.clone(), kt=kt, tile=128, k_splits=k_splits)
    torch.cuda.synchronize()
    assert kern.launches == n + 1
    assert torch.equal(got, want) and not torch.equal(got, C)


@pytest.mark.parametrize("variant", sweep.PACKED_BF16)
@pytest.mark.parametrize("k_splits", [1, 3, None])
def test_sweep_packed_splits_match_plain(card, variant, k_splits):
    """bf16 and bf16_ns on gram_bf16.cuh's packed block over the split-K
    grid (None: the planner's choice), at kt 512 and 128: random bytes,
    Bi != Bj, weights over every bit with 127, 128, 255, 256 among them, C
    seeded at 2^31 and above."""
    S, P = 512, 8192
    rng = np.random.default_rng(len(variant) + (k_splits or 0))
    Bi, Bj = (torch.from_numpy(rng.integers(0, 256, size=(P // 8, S),
                                            dtype=np.uint8)).to(card)
              for _ in range(2))
    w = _u32(rng, P)
    w[:4] = (127, 128, 255, 256)
    w = torch.from_numpy(w.view(np.int32)).to(card)
    C = torch.from_numpy((_u32(rng, (S, S)) | np.uint32(1 << 31))
                         .view(np.int32)).to(card)
    kern = sweep.KERNELS[variant]
    for kt in (512, 128):
        n = kern.launches
        want = sweep.plain(variant, w, Bi, Bj, C.clone(), kt=kt, tile=128)
        got = kern(w, Bi, Bj, C.clone(), kt=kt, tile=128, k_splits=k_splits)
        torch.cuda.synchronize()
        assert kern.launches == n + 1
        assert kern.k_splits == (k_splits or sweep.dot_splits(
            sweep.n_blocks(S, 128), P // kt, gram._n_sm(card.index)))
        assert torch.equal(got, want) and not torch.equal(got, C)


@pytest.mark.parametrize("variant", sweep.PACKED_BF16)
@pytest.mark.parametrize("k_splits", [1, None])
def test_sweep_packed_flush_case(card, variant, k_splits):
    """Every byte 0xFF and weights drawn from 129..255 at kt 65,536, P
    131,072, S 256: each K block's f32 sum per cell is at most 255 *
    65,536, below 2^24, and a lower cell of bf16 gains the weights' sum,
    about 2.5 * 10^7 > 2^24 and not a multiple of a large power of two,
    which a kernel that carried f32 sums across K blocks would round
    (bf16_ns gains 2 * 65,536 and runs the same block).  C seeded at 2^31
    and above."""
    S, P, kt = 256, 131072, 65536
    rng = np.random.default_rng(7)
    Bp = torch.full((P // 8, S), 255, dtype=torch.uint8, device=card)
    w_np = rng.integers(129, 256, size=P, dtype=np.int32)
    w = torch.from_numpy(w_np).to(card)
    C = torch.from_numpy((_u32(rng, (S, S)) | np.uint32(1 << 31))
                         .view(np.int32)).to(card)
    want = sweep.plain(variant, w, Bp, Bp, C.clone(), kt=kt, tile=128)
    got = sweep.KERNELS[variant](w, Bp, Bp, C.clone(), kt=kt, tile=128,
                                 k_splits=k_splits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    band = torch.arange(S, device=card) // 128
    lower = band[:, None] >= band[None, :]
    gain = int(w_np.sum()) if variant == "bf16" else 2 * kt
    assert variant != "bf16" or gain > 1 << 24
    moved = (got.to(torch.int64) - C.to(torch.int64)) & 0xFFFFFFFF
    assert bool((moved[lower] == gain).all()) and not moved[~lower].any()


#: (S, P, kt, tile, k_splits): nodot at kt = tile (one stage a K block at
#: 128, two at 256), kt above tile, several K blocks and one, at one split,
#: at uneven splits and at the planner's
NODOT_CASES = [(384, 128, 128, 128, None), (512, 1024, 128, 128, None),
               (512, 2048, 256, 256, 3), (512, 4096, 512, 256, 1),
               (384, 2560, 512, 128, None), (640, 3072, 1024, 128, 2)]


@pytest.mark.parametrize("S,P,kt,tile,k_splits", NODOT_CASES,
                         ids=["-".join(map(str, c)) for c in NODOT_CASES])
def test_sweep_nodot_on_the_packed_staging(card, S, P, kt, tile, k_splits):
    """nodot on the bf16 block's packed staging (csrc/gram_sweep.cu) ==
    its plain version: random bytes, Bi != Bj, C seeded non-zero; its
    k_splits the planner's where none is given."""
    rng = np.random.default_rng(S + P + kt + tile)
    Bi, Bj = (torch.from_numpy(rng.integers(0, 256, size=(P // 8, S),
                                            dtype=np.uint8)).to(card)
              for _ in range(2))
    w = torch.zeros(P, dtype=torch.int32, device=card)
    C = torch.from_numpy(_u32(rng, (S, S)).view(np.int32)).to(card)
    kern = sweep.KERNELS["nodot"]
    n = kern.launches
    want = sweep.plain("nodot", w, Bi, Bj, C.clone(), kt=kt, tile=tile)
    got = kern(w, Bi, Bj, C.clone(), kt=kt, tile=tile, k_splits=k_splits)
    torch.cuda.synchronize()
    assert kern.launches == n + 1
    assert kern.k_splits == (k_splits or sweep.dot_splits(
        sweep.n_blocks(S, tile), P // kt, gram._n_sm(card.index)))
    assert torch.equal(got, want) and not torch.equal(got, C)


@pytest.mark.skipif(not native.available, reason="no native host runtime")
@pytest.mark.parametrize("dedup", ["0", "1"])
def test_fused_tier_matches_host_tier(card, monkeypatch, dedup):
    """all2all_group_counts on the card, raw groups and patterns, over
    several merge partitions, against its host tier."""
    from kmerdb_tpu_torch.models import builder
    from kmerdb_tpu_torch.ops import fused
    rng = np.random.default_rng(31)
    pool = rng.integers(0, 1 << 40, size=30_000, dtype=np.uint64)
    streams = [np.unique(rng.choice(pool, size=int(rng.integers(500, 9000)),
                                    replace=False)) for _ in range(300)]
    monkeypatch.setattr(builder, "_PARTITION_ELEMS", 200_000)
    host = fused.all2all_group_counts(streams, force=False)
    monkeypatch.setenv("KMERDB_FUSED_DEDUP", dedup)
    n = gram.gram_u32_pk_tri.launches, gram.tril_tiles.launches
    got = fused.all2all_group_counts(streams, force=True)
    st = fused.last_stats
    assert st["route"] == ("dedup" if dedup == "1" else "raw")
    assert (gram.gram_u32_pk_tri.launches - n[0],
            gram.tril_tiles.launches - n[1]) == \
        (st["launches"]["gram_pk_tri"], st["launches"]["tril_tiles"])
    np.testing.assert_array_equal(got, host)


@pytest.mark.skipif(not native.available, reason="no native host runtime")
def test_fused_cli_matches_host_tier(card, tmp_path, monkeypatch):
    """`all2all -from-fasta` and `all2all-sp -from-fasta` on the card, raw
    groups and patterns, write the host tier's bytes."""
    from kmerdb_tpu_torch.cli.main import main
    from kmerdb_tpu_torch.utils import bench_corpus
    lst = bench_corpus.generate_scale(str(tmp_path / "corpus"),
                                      n_samples=300, genome_len=3000,
                                      seed=5)
    for mode in ("all2all", "all2all-sp"):
        outs = {}
        for name, env in (("host", {"KMERDB_FUSED_DEVICE": "0"}),
                          ("raw", {"KMERDB_FUSED_DEVICE": "1",
                                   "KMERDB_FUSED_DEDUP": "0"}),
                          ("dedup", {"KMERDB_FUSED_DEVICE": "1",
                                     "KMERDB_FUSED_DEDUP": "1"})):
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            out = tmp_path / f"{mode}-{name}.csv"
            n = gram.gram_u32_pk_tri.launches
            assert main([mode, "-from-fasta", lst, str(out)]) == 0
            assert (gram.gram_u32_pk_tri.launches > n) == (name != "host")
            outs[name] = out.read_bytes()
        assert outs["raw"] == outs["dedup"] == outs["host"]
