"""The port's all2all device tier against kmerdb_tpu's and the host tier.

kmerdb_tpu_torch.ops.device_a2a.all2all_device runs here on device="cpu"
(the kernels' plain versions); kmerdb_tpu's all2all_device runs its Pallas
kernels in the interpreter; native.a2a_dense is the host C++ tier.  All
three must agree exactly.
"""

import numpy as np
import pytest
import torch

from kmerdb_tpu.models import builder
from kmerdb_tpu.models.database import KmerPatternDb
from kmerdb_tpu.ops import device_a2a as jax_device_a2a
from kmerdb_tpu.utils import native
from kmerdb_tpu_torch import _torchinit
from kmerdb_tpu_torch.ops import device_a2a, intersect

pytestmark = pytest.mark.skipif(not native.available,
                                reason="no native host runtime")


def _random_db(rng, S, P, max_len=20, max_w=300_000):
    """As tests/test_a2a_paths.py: random patterns, weights up to 3 limbs."""
    lens = rng.integers(1, min(max_len, S + 1), size=P)
    offs = np.zeros(P + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    sids = np.empty(offs[-1], dtype=np.uint32)
    for p in range(P):
        k = int(lens[p])
        sids[offs[p]:offs[p + 1]] = np.sort(
            rng.choice(S, size=k, replace=False)).astype(np.uint32)
    w = rng.integers(1, max_w, size=P).astype(np.uint32)
    return _with_own_counts(KmerPatternDb(
        kmer_length=18, sample_names=[f"s{i}" for i in range(S)],
        pattern_offsets=offs, pattern_sample_ids=sids, pattern_num_kmers=w))


def _host(db):
    return native.a2a_dense(db.pattern_offsets, db.pattern_sample_ids,
                            db.pattern_num_kmers, db.n_samples)


def _with_own_counts(db):
    """Sample k-mer counts as a built database holds them (C's diagonal):
    both device tiers narrow the pull to uint16 when they all fit."""
    db.sample_kmer_counts = np.diag(_host(db)).copy()
    return db


def _two_class_db():
    """As tests/test_pallas_gram.py::test_all2all_device_packed_matches_host:
    light and heavy patterns from a real build."""
    rng = np.random.default_rng(23)
    samples = []
    for i in range(40):
        small = rng.choice(4000, size=300, replace=False).astype(np.uint64)
        big = rng.integers(1 << 20, 1 << 36,
                           size=rng.integers(300, 2000)).astype(np.uint64)
        samples.append((f"s{i}", np.unique(np.concatenate([small, big]))))
    return builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        samples)


def _wraparound_db():
    """As tests/test_a2a_paths.py::test_u32_wraparound_exactness."""
    return _with_own_counts(KmerPatternDb(
        kmer_length=18, sample_names=list("abcd"),
        pattern_offsets=np.array([0, 2, 4, 6], dtype=np.int64),
        pattern_sample_ids=np.array([0, 1, 0, 1, 0, 1], dtype=np.uint32),
        pattern_num_kmers=np.array([0xF0000000, 0xF0000000, 0x30000000],
                                   dtype=np.uint32)))


@pytest.mark.parametrize("case", [
    "random-0-13-50", "random-1-64-400", "random-2-200-37", "two-class",
    "wraparound"])
def test_all2all_device_matches_jax_and_host(case, monkeypatch):
    if case.startswith("random"):
        _, seed, S, P = case.split("-")
        db = _random_db(np.random.default_rng(int(seed)), int(S), int(P))
    elif case == "two-class":
        monkeypatch.setenv("KMERDB_A2A_GROUP_MB", "1")
        db = _two_class_db()
    else:
        db = _wraparound_db()
    host = _host(db)
    got = device_a2a.all2all_device(db, device="cpu")
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(jax_device_a2a.all2all_device(db), host)
    st = device_a2a.last_stats
    assert st["device"] == "cpu" and st["S"] == db.n_samples
    assert st["light_patterns"] + st["heavy_patterns"] == db.n_patterns
    if case == "two-class":
        assert st["light_patterns"] > 0 and st["heavy_patterns"] > 0
    if case == "wraparound":
        assert got[0, 1] == (0xF0000000 * 2 + 0x30000000) % (1 << 32)


def test_group_plan_bounds_the_scratch(monkeypatch):
    """KMERDB_A2A_GROUP_MB caps the packed rows of a group; each class is
    split into groups padded to kt."""
    monkeypatch.setenv("KMERDB_A2A_GROUP_MB", "1")
    light, heavy = np.arange(5000), np.arange(5000, 5300)
    group_rows, groups = device_a2a._group_plan(light, heavy, 3, 4096, 256)
    assert group_rows == (1 << 20) * 8 // 4096
    assert [(g.size, n, rows) for g, n, rows in groups] == [
        (2048, 1, 2048), (2048, 1, 2048), (904, 1, 1024), (300, 3, 512)]
    assert np.array_equal(np.concatenate([g for g, _, _ in groups]),
                          np.arange(5300))


def test_plan_flops_counts_padded_limbs():
    db = _random_db(np.random.default_rng(4), 100, 300)
    light, heavy, limbs = device_a2a._limb_split(db.pattern_num_kmers)
    assert limbs == 3                        # weights below 300,000 < 2^21
    kt, tile, S_pad = device_a2a._geometry(db.n_samples)
    rows = -(-light.size // kt) * kt + 3 * (-(-heavy.size // kt) * kt)
    assert device_a2a.plan_flops(db) == 2.0 * rows * S_pad * S_pad


def test_forced_device_tier_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        intersect.all2all_counts(_wraparound_db())


def test_device_failure_is_not_recomputed_on_host(monkeypatch):
    def boom(db, device=None):
        raise RuntimeError("device fault")

    monkeypatch.setattr(device_a2a, "all2all_device", boom)
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "1")
    with pytest.raises(RuntimeError, match="device fault"):
        intersect.all2all_counts(_wraparound_db())


@pytest.mark.parametrize("env,cuda,big,tier", [
    ("1", False, False, "device"), ("0", True, True, "host"),
    ("", False, True, "host"), ("", True, False, "host"),
    ("", True, True, "device")])
def test_tier_choice(env, cuda, big, tier, monkeypatch):
    """KMERDB_A2A_DEVICE forces a tier; unset, the device tier needs CUDA
    and a host cost of at least costcal's fixed_s."""
    db = _random_db(np.random.default_rng(9), 40, 60)
    monkeypatch.setenv("KMERDB_A2A_DEVICE", env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))
    monkeypatch.setenv("KMERDB_COST_DEV_FIXED_S",
                       "0" if big else "1e9")
    ran = []
    real = device_a2a.all2all_device
    monkeypatch.setattr(device_a2a, "all2all_device",
                        lambda db: ran.append(1) or real(db))
    np.testing.assert_array_equal(intersect.all2all_counts(db), _host(db))
    assert ("device" if ran else "host") == tier
