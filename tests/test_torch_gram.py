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
