"""The port's kernels (kmerdb_tpu_torch/ops/gram.py) against kmerdb_tpu's.

The JAX side runs the Pallas kernels in the interpreter, as the JAX
package's own tests do on the CPU; the port's side runs the plain PyTorch
versions, which is what its wrappers do with CPU tensors.  Counts are
integers mod 2^32, so every comparison is exact equality.  The CUDA
kernels themselves are held to the plain versions on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerdb_tpu.ops import pallas_gram
from kmerdb_tpu_torch.ops import gram


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _packed_case(rng, S, rows, wmax, tile):
    S_pad = -(-S // tile) * tile
    B = np.zeros((rows, S_pad), dtype=np.uint8)
    B[:, :S] = (rng.random((rows, S)) < 0.2).astype(np.uint8)
    Bp = np.zeros((rows // 8, S_pad), dtype=np.uint8)
    for i in range(rows):
        Bp[i >> 3] |= B[i] << np.uint8(i & 7)
    w = rng.integers(0, wmax, size=rows).astype(np.uint32)
    C0 = rng.integers(0, 1 << 32, size=(S_pad, S_pad),
                      dtype=np.uint64).astype(np.uint32)
    return Bp, w, C0


@pytest.mark.parametrize("S,rows,wmax,kt,tile,seed", [
    (100, 1024, 120, 512, 128, 21),           # light class: one 7-bit limb
    (300, 1024, 16_000_000, 512, 128, 22),    # four 7-bit limbs
    (300, 2048, 120, 1024, 128, 24),          # kt 1024, 1 limb
    (520, 2048, 120, 1024, 512, 23),          # coarse 512 triangle
])
def test_gram_pk_tri_matches_jax(S, rows, wmax, kt, tile, seed):
    """Twice over the same seeded non-zero C: accumulation, the triangle
    contract (strict-upper tiles keep C) and the weight order for kt."""
    rng = np.random.default_rng(seed)
    Bp, w, C0 = _packed_case(rng, S, rows, wmax, tile)
    n_limbs = max(1, -(-int(w.max()).bit_length() // 7))
    wpk = pallas_gram.pk_weight_order(w, kt).reshape(-1, 1)

    C = jnp.asarray(C0)
    for _ in range(2):
        C = pallas_gram.gram_u32_pk_tri(
            jnp.asarray(Bp), jnp.asarray(wpk), C, n_limbs=n_limbs, kt=kt,
            tile=tile, engine="s8")
    want = np.asarray(C)

    Bt, wt, Ct = gram.from_jax_layout(Bp, wpk, C0, "cpu")
    for _ in range(2):
        gram.gram_u32_pk_tri(Bt, wt, Ct, n_limbs=n_limbs, kt=kt, tile=tile)
    np.testing.assert_array_equal(_u32(Ct), want)
    assert not np.array_equal(want, C0)


def _bf16_weights(rng, rows, wbits):
    """Distinct-ish uint32 weights below 2^wbits, a quarter of them with
    every limb byte in 129..255 (partials that are no multiple of 16)."""
    w = rng.integers(0, 1 << wbits, size=rows, dtype=np.uint64)
    q = rng.random(rows) < 0.25
    w[q] = sum(rng.integers(129, 256, size=int(q.sum()), dtype=np.uint64)
               << np.uint64(8 * l) for l in range(-(-wbits // 8)))
    return (w & np.uint64((1 << wbits) - 1)).astype(np.uint32)


@pytest.mark.parametrize("S,rows,n_limbs,wbits,kt,tile,seed", [
    (100, 1024, 1, 8, 512, 128, 41),       # the light class: one 8-bit limb
    (300, 1024, 2, 16, 256, 128, 42),      # two limbs, kt 256
    (300, 2048, 4, 32, 1024, 128, 43),     # four limbs, every weight bit
    (260, 1024, 2, 30, 512, 256, 44),      # bits 16-29 dropped; tile 256
])
def test_gram_pk_tri_bf16_matches_jax(S, rows, n_limbs, wbits, kt, tile,
                                      seed):
    """The bf16 engine (8-bit limbs, an f32 sum a K block): the port's
    wrapper on the CPU == kmerdb_tpu's gram_u32_pk_tri(engine="bf16"),
    interpreted, twice over C seeded at 2^31 and above; weights wider than
    8 * n_limbs bits lose their high bits in both."""
    rng = np.random.default_rng(seed)
    Bp, _, _ = _packed_case(rng, S, rows, 2, tile)
    w = _bf16_weights(rng, rows, wbits)
    assert np.unique(w).size > min(rows // 2, 200)
    C0 = rng.integers(1 << 31, 1 << 32, size=(Bp.shape[1],) * 2,
                      dtype=np.uint64).astype(np.uint32)
    wpk = pallas_gram.pk_weight_order(w, kt).reshape(-1, 1)

    C = jnp.asarray(C0)
    for _ in range(2):
        C = pallas_gram.gram_u32_pk_tri(
            jnp.asarray(Bp), jnp.asarray(wpk), C, n_limbs=n_limbs, kt=kt,
            tile=tile, engine="bf16")
    want = np.asarray(C)

    Bt, wt, Ct = gram.from_jax_layout(Bp, wpk, C0, "cpu")
    for _ in range(2):
        gram.gram_u32_pk_tri(Bt, wt, Ct, n_limbs=n_limbs, kt=kt, tile=tile,
                             engine="bf16")
    np.testing.assert_array_equal(_u32(Ct), want)
    # the lower tiles gained twice the Gram of the limbed weights
    B = np.unpackbits(Bp, axis=0, bitorder="little").astype(np.uint64)
    wl = w.astype(np.uint64) & np.uint64((1 << (8 * n_limbs)) - 1)
    G = ((B.T * wl) @ B) & 0xFFFFFFFF
    band = np.arange(Bp.shape[1]) // tile
    lower = band[:, None] >= band[None, :]
    np.testing.assert_array_equal(
        want[lower], ((C0.astype(np.uint64) + 2 * G) & 0xFFFFFFFF)
        .astype(np.uint32)[lower])
    np.testing.assert_array_equal(want[~lower], C0[~lower])


#: (form, S or S1, S2 or stripe rows, limbs, weight bits, K blocks): the
#: bf16 forms at kt 128, one stage of the card's packed block a K block, so
#: every stage ends with a flush; C seeded at 2^31 and above; one tile of
#: one K block too
BF16_KT128_CASES = [("tri", 256, 256, 1, 8, 5), ("tri", 384, 384, 4, 32, 3),
                    ("tri", 128, 128, 2, 16, 1),
                    ("rows", 384, 128, 2, 16, 4), ("rows", 512, 256, 4, 30, 2),
                    ("rows", 256, 128, 1, 8, 1),
                    ("cross", 128, 384, 1, 8, 5), ("cross", 384, 256, 4, 32, 3),
                    ("cross", 256, 128, 2, 16, 1)]


@pytest.mark.parametrize("form,S1,S2,n_limbs,wbits,k_blocks", BF16_KT128_CASES,
                         ids=["-".join(map(str, c)) for c in BF16_KT128_CASES])
def test_bf16_forms_at_kt_128_match_jax(form, S1, S2, n_limbs, wbits,
                                        k_blocks):
    """The bf16 engine's triangle, stripe (rt0 1) and rectangle (two row
    pitches) at kt 128: the port's wrappers on the CPU == kmerdb_tpu's
    interpreted kernels with engine="bf16"."""
    kt, tile, rows = 128, 128, 128 * k_blocks
    rng = np.random.default_rng(S1 + S2 + n_limbs + wbits)
    U = (rng.random((rows, S1)) < 0.3).astype(np.uint8)
    V = (rng.random((rows, S2)) < 0.3).astype(np.uint8)
    Up, Vp = (np.packbits(X, axis=0, bitorder="little") for X in (U, V))
    w = _bf16_weights(rng, rows, wbits)
    wpk = pallas_gram.pk_weight_order(w, kt)
    shape = {"tri": (S1, S1), "rows": (S2, S1), "cross": (S1, S2)}[form]
    C0 = rng.integers(1 << 31, 1 << 32, size=shape,
                      dtype=np.uint64).astype(np.uint32)
    kw = dict(n_limbs=n_limbs, kt=kt, engine="bf16")
    jargs = (jnp.asarray(Up), jnp.asarray(wpk.reshape(-1, 1)),
             jnp.asarray(C0))
    Ut, wt, Ct = gram.from_jax_layout(Up, wpk.reshape(-1, 1), C0, "cpu")
    if form == "tri":
        want = pallas_gram.gram_u32_pk_tri(*jargs, tile=tile, **kw)
        got = gram.gram_u32_pk_tri(Ut, wt, Ct, tile=tile, **kw)
    elif form == "rows":
        want = pallas_gram.gram_u32_pk_rows(*jargs, 1, tile=tile, **kw)
        got = gram.gram_u32_pk_rows(Ut, wt, Ct, 1, tile=tile, **kw)
    else:
        want = pallas_gram.cross_u32_pk(
            jargs[0], jnp.asarray(Vp), *jargs[1:], tile=tile, interpret=True,
            **kw)
        got = gram.cross_u32_pk(Ut, torch.from_numpy(Vp), wt, Ct, **kw)
    assert got is Ct
    np.testing.assert_array_equal(_u32(Ct), np.asarray(want))
    assert not np.array_equal(_u32(Ct), C0)


def test_gram_pk_tri_wraps_mod_2_32():
    """Counts past 2^32 wrap exactly as uint32 (the reference's
    num_kmers_t): every limb at its largest weight."""
    rng = np.random.default_rng(5)
    Bp = np.full((128 // 8, 128), 0xFF, dtype=np.uint8)
    w = np.full(128, 0xFFFFFFFF, dtype=np.uint32)
    w[::3] = rng.integers(1 << 31, 1 << 32, size=w[::3].size,
                          dtype=np.uint64).astype(np.uint32)
    C0 = np.full((128, 128), 0xFFFFFFF0, dtype=np.uint32)
    want = ((C0.astype(np.uint64) + int(w.astype(np.uint64).sum()))
            & 0xFFFFFFFF).astype(np.uint32)
    Bt, wt, Ct = gram.from_jax_layout(
        Bp, gram.pk_weight_order(w, 128), C0, "cpu")
    gram.gram_u32_pk_tri(Bt, wt, Ct, n_limbs=gram.MAX_LIMBS, kt=128)
    np.testing.assert_array_equal(_u32(Ct), want)


@pytest.mark.parametrize("dtype,jdt,vmax", [
    (torch.int16, jnp.uint16, 1 << 16), (torch.int32, jnp.uint32, 1 << 32)])
def test_tril_tiles_matches_jax(dtype, jdt, vmax):
    rng = np.random.default_rng(7)
    C = rng.integers(0, vmax, size=(384, 384),
                     dtype=np.uint64).astype(np.uint32)
    want = np.asarray(pallas_gram.tril_tiles(jnp.asarray(C), dtype=jdt))
    got = gram.tril_tiles(torch.from_numpy(C.view(np.int32)), dtype)
    np.testing.assert_array_equal(
        got.numpy().view(np.uint16 if dtype == torch.int16 else np.uint32),
        want)


@pytest.mark.parametrize("nt", [1, 3, 8])
def test_tile_tables_untile_and_weight_order_match_jax(nt):
    for a, b in zip(gram.tri_tile_tables(nt),
                    pallas_gram.tri_tile_tables(nt)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(nt)
    tiles = rng.integers(0, 1 << 32, size=(nt * (nt + 1) // 2, 128, 128),
                         dtype=np.uint64).astype(np.uint32)
    S = nt * 128 - 5
    np.testing.assert_array_equal(gram.untile_symmetric(tiles, S),
                                  pallas_gram.untile_symmetric(tiles, S))
    w = rng.integers(0, 1 << 32, size=2 * 512,
                     dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(gram.pk_weight_order(w, 512),
                                  pallas_gram.pk_weight_order(w, 512))


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(3)
    Bp, w, C0 = _packed_case(rng, 128, 256, 100, 128)
    Bt, wt, Ct = gram.from_jax_layout(
        Bp, gram.pk_weight_order(w, 256), C0, "cpu")
    n_gram, n_tril = gram.gram_u32_pk_tri.launches, gram.tril_tiles.launches
    plain = gram.gram_u32_pk_tri_plain(Bt, wt, Ct.clone(), n_limbs=1,
                                       kt=256)
    assert torch.equal(gram.gram_u32_pk_tri(Bt, wt, Ct, n_limbs=1, kt=256),
                       plain)
    gram.tril_tiles(Ct)
    assert (gram.gram_u32_pk_tri.launches, gram.tril_tiles.launches) == \
        (n_gram, n_tril)


@pytest.mark.parametrize("bad,kw", [
    ("engine", dict(engine="fp8")),
    ("bf16 n_limbs 0", dict(engine="bf16", n_limbs=0)),
    ("bf16 n_limbs 5", dict(engine="bf16", n_limbs=5)),
    ("bf16 kt", dict(engine="bf16", kt=65920))])
def test_gram_wrappers_refuse_what_no_engine_takes(bad, kw):
    """n_limbs outside 1..4 and 255 * kt >= 2^24 under bf16 (65,920 is
    the first multiple of 128 there) are refused with ValueError, by every
    form and its plain version, never run on another route."""
    P = 65920
    Bp = torch.zeros((P // 8, 128), dtype=torch.uint8)
    w = torch.zeros(P, dtype=torch.int32)
    C = torch.zeros((128, 128), dtype=torch.int32)
    kw = dict(dict(n_limbs=1, kt=512), **kw)
    for call in (lambda: gram.gram_u32_pk_tri(Bp, w, C, **kw),
                 lambda: gram.gram_u32_pk_tri_plain(Bp, w, C, **kw),
                 lambda: gram.gram_u32_pk_rows(Bp, w, C, 0, **kw),
                 lambda: gram.cross_u32_pk(Bp, Bp, w, C, **kw)):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("bad", [
    "Bp_dtype", "w_size", "C_shape", "kt", "tile", "n_limbs",
    "noncontiguous", "device"])
def test_gram_wrapper_rejects_bad_operands(bad):
    Bp = torch.zeros((32, 256), dtype=torch.uint8)
    w = torch.zeros(256, dtype=torch.int32)
    C = torch.zeros((256, 256), dtype=torch.int32)
    kw = dict(n_limbs=1, kt=256, tile=128)
    err = ValueError
    if bad == "Bp_dtype":
        Bp = Bp.to(torch.int8)
    elif bad == "w_size":
        w = w[:128]
    elif bad == "C_shape":
        C = C[:128, :128].contiguous()
    elif bad == "kt":
        kw["kt"] = 64
    elif bad == "tile":
        kw["tile"] = 192
    elif bad == "n_limbs":
        kw["n_limbs"] = gram.MAX_LIMBS + 1
    elif bad == "noncontiguous":
        C = torch.zeros((256, 512), dtype=torch.int32)[:, ::2]
    elif bad == "device":
        Bp, w, C = (t.to("meta") for t in (Bp, w, C))
        err = RuntimeError
    with pytest.raises(err):
        gram.gram_u32_pk_tri(Bp, w, C, **kw)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_tril_wrapper_rejects_bad_operands(bad):
    C = torch.zeros((256, 256), dtype=torch.int32)
    dtype, err = torch.int16, ValueError
    if bad == "dtype":
        dtype = torch.uint8
    elif bad == "shape":
        C = C[:200, :200].contiguous()
    else:
        C, err = C.to("meta"), RuntimeError
    with pytest.raises(err):
        gram.tril_tiles(C, dtype)
