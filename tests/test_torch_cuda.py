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


@pytest.mark.skipif(not native.available, reason="no native host runtime")
def test_all2all_device_matches_host_tier(card):
    rng = np.random.default_rng(2)
    S, P = 300, 3000
    lens = rng.integers(1, 40, size=P)
    offs = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    sids = np.concatenate([np.sort(rng.choice(S, size=k, replace=False))
                           for k in lens]).astype(np.uint32)
    w = rng.integers(1, 1 << 20, size=P).astype(np.uint32)
    host = native.a2a_dense(offs, sids, w, S)
    db = KmerPatternDb(kmer_length=18,
                       sample_names=[f"s{i}" for i in range(S)],
                       sample_kmer_counts=np.diag(host).copy(),
                       pattern_offsets=offs, pattern_sample_ids=sids,
                       pattern_num_kmers=w)
    np.testing.assert_array_equal(device_a2a.all2all_device(db), host)
    assert device_a2a.last_stats["device"] == "cuda"
    assert device_a2a.last_stats["gram_s"] > 0
