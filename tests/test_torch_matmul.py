"""The query contraction's grid and limb planes (kmerdb_tpu_torch/ops/gram.py).

csrc/matmul_acc.cu cuts the patterns of each 128 x 128 output block into
k_splits runs of whole 128-pattern stages (``matmul_splits`` picks k_splits,
``split_stages`` is the kernel's cut) and reads uint32 H as 8-bit limb
planes (``limb_planes``).  Here, on the CPU: the planner at new2all's shapes
and at its limits, the cut covering every stage once, the wrappers refusing
a k_splits the kernel cannot take, the planes' plain version against numpy,
and the product over the planes against kmerdb_tpu's matmul_u32_acc run in
the interpreter.  The kernel itself is held to the plain versions on a card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerdb_tpu.ops import pallas_gram
from kmerdb_tpu_torch.ops import gram

#: an H100 SXM's SMs
H100_SMS = 132


def _u32(rng, shape, lo=0):
    return rng.integers(lo, 1 << 32, size=shape,
                        dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("q_pad,want", [(512, 1), (128, 4)])
def test_matmul_splits_at_new2all_shapes(q_pad, want):
    """A 512-query flush and the 76-query flush or a mesh slot (Q_pad 128)
    against the 4,096-sample database's chunk (P_pad 10,496): 128 blocks,
    about one an SM."""
    k = gram.matmul_splits(q_pad, 4096, 10_496, H100_SMS)
    assert k == want
    assert (q_pad // 128) * (4096 // 128) * k == 128


@pytest.mark.parametrize("q_pad,s_pad,p_pad,n_sm,want", [
    (1024, 8192, 10_496, H100_SMS, 1),      # 512 blocks fill the card
    (512, 20_480, 10_496, H100_SMS, 1),     # 640 blocks
    (128, 8192, 10_496, H100_SMS, 2),       # 64 blocks
    (256, 512, 10_496, H100_SMS, 16),       # 8 blocks, 16 splits
    (128, 128, 384, H100_SMS, 3),           # only 3 stages
    (128, 128, 128, H100_SMS, 1),           # one stage
    (128, 128, 0, H100_SMS, 1),             # no pattern
    (128, 4096, 10_496, 1, 1),              # one SM: 32 blocks fill it
])
def test_matmul_splits_limits(q_pad, s_pad, p_pad, n_sm, want):
    k = gram.matmul_splits(q_pad, s_pad, p_pad, n_sm)
    assert k == want
    assert 1 <= k <= max(1, p_pad // 128)


@pytest.mark.parametrize("n_stages", [1, 5, 82, 83, 65_538])
def test_split_stages_cover_every_stage_once(n_stages):
    for k in sorted({1, 2, 3, 7, 8, min(n_stages, 64), n_stages}):
        if k > n_stages:
            continue
        runs = gram.split_stages(n_stages, k)
        assert len(runs) == k
        covered = [s for first, n in runs for s in range(first, first + n)]
        assert covered == list(range(n_stages))
        sizes = {n for _, n in runs}
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("fn", ["matmul_u32_acc", "matmul_u32"])
@pytest.mark.parametrize("k_splits", [0, -1, 5, 2.0])
def test_wrappers_refuse_k_splits_outside_the_stages(fn, k_splits):
    """P 512 holds 4 stages: k_splits must be an int in 1..4."""
    rng = np.random.default_rng(3)
    H = torch.from_numpy(rng.integers(0, 256, (128, 512), dtype=np.uint8))
    B = torch.from_numpy((rng.random((512, 128)) < 0.3).astype(np.int8))
    args = (H, B) + ((torch.zeros((128, 128), dtype=torch.int32),)
                     if fn == "matmul_u32_acc" else ())
    with pytest.raises(ValueError, match="k_splits"):
        getattr(gram, fn)(*args, n_limbs=1, k_splits=k_splits)


@pytest.mark.parametrize("k_splits", [None, 1, 3, 4])
def test_wrappers_take_k_splits_in_range(k_splits):
    """Any k_splits in 1..P / 128 gives the one product: on the CPU the
    plain version, which k_splits does not change."""
    rng = np.random.default_rng(4)
    H = torch.from_numpy(_u32(rng, (128, 512)).view(np.int32))
    B = torch.from_numpy((rng.random((512, 256)) < 0.3).astype(np.int8))
    C0 = torch.from_numpy(_u32(rng, (128, 256)).view(np.int32))
    fresh = gram.matmul_u32(H, B, n_limbs=4, k_splits=k_splits)
    acc = gram.matmul_u32_acc(H, B, C0.clone(), n_limbs=4,
                              k_splits=k_splits)
    assert torch.equal(fresh, gram.matmul_u32_plain(H, B, n_limbs=4))
    assert torch.equal(acc, gram.matmul_u32_acc_plain(H, B, C0.clone(),
                                                      n_limbs=4))


@pytest.mark.parametrize("n_limbs", [1, 2, 3, 4])
def test_limb_planes_plain_matches_numpy(n_limbs):
    """Words of every byte value and at 2^31 and above (negative in int32
    storage)."""
    rng = np.random.default_rng(n_limbs)
    H = _u32(rng, (128, 256), lo=1 << 31)
    H[0, :256] = np.arange(256, dtype=np.uint32) * 0x01010101
    got = gram.limb_planes(torch.from_numpy(H.view(np.int32)), n_limbs)
    want = np.stack([(H >> np.uint32(8 * l)) & np.uint32(0xFF)
                     for l in range(n_limbs)]).astype(np.uint8)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gram.limb_planes_plain(torch.from_numpy(H.view(np.int32)),
                               n_limbs).numpy(), want)


@pytest.mark.parametrize("bad", ["uint8", "ragged", "limbs"])
def test_limb_planes_refuse_bad_operands(bad):
    H = torch.zeros((128, 256), dtype=torch.int32)
    if bad == "uint8":
        H = H.to(torch.uint8)
    elif bad == "ragged":
        H = torch.zeros((128, 200), dtype=torch.int32)
    with pytest.raises(ValueError):
        gram.limb_planes(H, 5 if bad == "limbs" else 2)


@pytest.mark.parametrize("n_limbs,k_splits", [(2, 5), (3, 7), (4, 1)])
def test_product_over_planes_and_splits_matches_jax(n_limbs, k_splits):
    """The kernel's decomposition on the CPU: each split's run of stages
    (split_stages) times each limb plane (limb_planes), shifted by 8l and
    summed mod 2^32 into C, equals kmerdb_tpu's interpreted
    matmul_u32_acc over 12 stages (P a multiple of its K block, 512; the
    splits uneven) and the port's plain version."""
    rng = np.random.default_rng(10 * n_limbs + k_splits)
    Q, P, S = 128, 1536, 256
    H = _u32(rng, (Q, P)) >> np.uint32(32 - 8 * n_limbs)
    B = (rng.random((P, S)) < 0.3).astype(np.int8)
    C0 = _u32(rng, (Q, S), lo=1 << 31)
    want = np.asarray(pallas_gram.matmul_u32_acc(
        jnp.asarray(H), jnp.asarray(B), jnp.asarray(C0), n_limbs=n_limbs,
        interpret=True))

    planes = gram.limb_planes(torch.from_numpy(H.view(np.int32)),
                              n_limbs).numpy().astype(np.uint64)
    got = C0.astype(np.uint64)
    for l in range(n_limbs):
        for first, n in gram.split_stages(P // 128, k_splits):
            k = slice(128 * first, 128 * (first + n))
            part = planes[l][:, k] @ B[k].astype(np.uint64)
            got = (got + (part << np.uint64(8 * l))) & np.uint64(0xFFFFFFFF)
    np.testing.assert_array_equal(got.astype(np.uint32), want)

    Ct = torch.from_numpy(C0.view(np.int32).copy())
    gram.matmul_u32_acc(torch.from_numpy(H.view(np.int32)),
                        torch.from_numpy(B), Ct, n_limbs=n_limbs,
                        k_splits=k_splits)
    np.testing.assert_array_equal(Ct.numpy().view(np.uint32), want)
