"""The kernel sweep of kmerdb_tpu_torch against kmerdb_tpu's, on the CPU.

Each Gram variant's plain version (ops/sweep.py, what the wrapper runs for
CPU tensors) is held to the variant that kmerdb_tpu's
``tools/kernel_sweep.build`` makes, run in the Pallas interpreter: the same
operands, made with numpy from a seed, at two geometries, with weights of
128 and 256 and above, Bi != Bj and C seeded non-zero; dotonly and
dotonly_T also on half-integer operands, whose per-K-block truncation
shows; bf16 and bf16_ns also at K blocks of 128 (one stage of the packed
block a K block) and with every byte 0xFF and every weight byte 255;
nodot also at kt = tile and at tile 256.
Tolerance: exact equality of the uint32 matrices.  Then the tool's
own functions on a CPU device: ops/device_a2a.kernel_bench's chained C and
its truncation under KMERDB_A2A_RESIDENT_MB, the records of run_variant
and sweep_on_db, that sweep_on_db gives the geometry knobs back, and the
split planner of the dotonly grid.
"""

import functools
import importlib.util
import os
import pathlib
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from kmerdb_tpu_torch.models.database import KmerPatternDb
from kmerdb_tpu_torch.ops import device_a2a, gram, sweep
from kmerdb_tpu_torch.tools import kernel_sweep
from kmerdb_tpu_torch.utils import native

REPO = pathlib.Path(__file__).resolve().parents[1]
S, P = 256, 2048


@pytest.fixture(scope="module")
def jax_sweep():
    """kmerdb_tpu's tools/kernel_sweep.py with its pallas_call interpreted,
    patched in that module's namespace only."""
    spec = importlib.util.spec_from_file_location(
        "kmerdb_tpu_kernel_sweep", REPO / "tools" / "kernel_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(**{
        **vars(mod.pl),
        "pallas_call": functools.partial(mod.pl.pallas_call,
                                         interpret=True)})
    return mod


#: the half-integer operand values of dotonly and dotonly_T
HALVES = np.array([-1.0, -0.5, 0.0, 0.5, 1.0, 1.5], np.float32)


def _operands(variant, rng, signed=False, halves=False, ones=False):
    """(jax operands, port operands) of one variant: Bi != Bj; with
    `signed`, dotonly_s8's int8 over the whole of -128..127; with `halves`,
    bf16 values in HALVES (exact in bf16); with `ones`, packed bytes 0xFF."""
    if ones:
        B = np.full((P // 8, S), 255, np.uint8)
        return (B, B), (torch.from_numpy(B), torch.from_numpy(B))
    if halves:
        Ri, Rj = (rng.choice(HALVES, size=(P, S)) for _ in range(2))
        if variant == "dotonly_T":
            Ri = np.ascontiguousarray(Ri.T)
        return ((Ri.astype(ml_dtypes.bfloat16),
                 Rj.astype(ml_dtypes.bfloat16)),
                tuple(torch.from_numpy(R).to(torch.bfloat16)
                      for R in (Ri, Rj)))
    if signed:
        Ri, Rj = (rng.integers(-128, 128, size=(P, S), dtype=np.int8)
                  for _ in range(2))
        Ri[:2, :2] = Rj[:2, :2] = -128
        return (Ri, Rj), (torch.from_numpy(Ri), torch.from_numpy(Rj))
    if variant in sweep.PACKED:
        Bi, Bj = (rng.integers(0, 256, size=(P // 8, S), dtype=np.uint8)
                  for _ in range(2))
        return (Bi, Bj), (torch.from_numpy(Bi), torch.from_numpy(Bj))
    Ri, Rj = (rng.integers(0, 2, size=(P, S), dtype=np.int8)
              for _ in range(2))
    if variant == "dotonly_T":
        Ri = np.ascontiguousarray(Ri.T)
    if variant == "dotonly_s8":
        return (Ri, Rj), (torch.from_numpy(Ri), torch.from_numpy(Rj))
    return ((Ri.astype(ml_dtypes.bfloat16), Rj.astype(ml_dtypes.bfloat16)),
            tuple(torch.from_numpy(R).to(torch.bfloat16) for R in (Ri, Rj)))


#: every variant at two geometries, dotonly_s8 on signed operands, dotonly
#: and dotonly_T on half-integer ones at K blocks of 128 and 512, bf16 and
#: bf16_ns at K blocks of 128 and with every bit and weight byte set, and
#: nodot at kt = tile (one stage of the packed block a K block at 128), at
#: tile 256 with kt above it, and at tile 128 with 2 and 8 stages a K block
VARIANT_CASES = [(v, kt, tile, "") for kt, tile in ((512, 128), (1024, 256))
                 for v in sweep.VARIANTS] + [("dotonly_s8", 512, 128, "signed")] \
    + [(v, kt, 128, "halves") for v in sweep.UNPACKED_BF16
       for kt in (128, 512)] \
    + [(v, 128, 128, "") for v in sweep.PACKED_BF16] \
    + [(v, 512, 128, "ones") for v in sweep.PACKED_BF16] \
    + [("nodot", kt, tile, "") for kt, tile in ((128, 128), (256, 256),
                                                (512, 256), (256, 128),
                                                (1024, 128))]


@pytest.mark.parametrize(
    "variant,kt,tile,operands", VARIANT_CASES,
    ids=[f"{v}-{kt}-{tile}" + (f"-{op}" if op else "")
         for v, kt, tile, op in VARIANT_CASES])
def test_variant_matches_jax_interpreted(jax_sweep, variant, kt, tile,
                                         operands):
    jnp = jax_sweep.jnp
    rng = np.random.default_rng(kt + sweep.VARIANTS.index(variant))
    w = rng.integers(0, 1 << 32, size=(P, 1), dtype=np.uint64) \
        .astype(np.uint32)
    w[:6, 0] = (127, 128, 255, 256, 257, 0xFFFFFFFF)  # each body masks w
    if operands == "ones":
        w[:] = 0xFFFFFFFF                         # every weight byte 255
    (ji, jj), (ti, tj) = _operands(variant, rng, signed=operands == "signed",
                                   halves=operands == "halves",
                                   ones=operands == "ones")
    C0 = rng.integers(0, 1 << 32, size=(S, S), dtype=np.uint64) \
        .astype(np.uint32)

    step, packed = jax_sweep.build(variant, S, P, kt, tile)
    assert packed == (variant in sweep.PACKED)
    want = np.asarray(step(jnp.asarray(w), jnp.asarray(ji), jnp.asarray(jj),
                           jnp.asarray(C0)))

    kern = sweep.KERNELS[variant]
    n = kern.launches
    C = torch.from_numpy(C0.view(np.int32).copy())
    got = kern(torch.from_numpy(w.reshape(-1).view(np.int32)), ti, tj, C,
               kt=kt, tile=tile)
    assert got is C and kern.launches == n      # the CPU runs the plain one
    np.testing.assert_array_equal(C.numpy().view(np.uint32), want)
    # strict-upper tiles keep C; the lower ones moved
    band = np.arange(S) // tile
    upper = band[:, None] < band[None, :]
    np.testing.assert_array_equal(want[upper], C0[upper])
    assert (want[~upper] != C0[~upper]).any()
    if operands == "ones":
        # every lower cell gains 255 a pattern (bf16_ns: 1)
        gain = (255 if variant == "bf16" else 1) * P
        np.testing.assert_array_equal(want[~upper],
                                      C0[~upper] + np.uint32(gain))
    if operands == "halves":
        # one truncation of the whole sum gives other numbers: the K
        # blocks' truncation is part of the function
        A = ji.astype(np.float64)
        A = A if variant == "dotonly_T" else A.T
        whole = np.trunc(A @ jj.astype(np.float64)).astype(np.int64)
        once = (C0.astype(np.int64) + whole).astype(np.uint32)
        assert (once[~upper] != want[~upper]).any()


def test_tool_build_is_the_port_kernel():
    step, packed = kernel_sweep.build("int8", S, P, 512, 128)
    assert packed
    rng = np.random.default_rng(5)
    w, Bi, Bj = kernel_sweep.operands("int8", S, P, "cpu")
    C = torch.from_numpy(rng.integers(0, 1 << 31, size=(S, S),
                                      dtype=np.int64).astype(np.int32))
    want = gram.gram_u32_pk_tri_plain(Bi, w, C.clone(), n_limbs=1, kt=512,
                                      tile=128)
    assert torch.equal(step(w, Bi, Bj, C), want)
    with pytest.raises(ValueError, match="unknown variant"):
        kernel_sweep.build("fp8", S, P, 512, 128)


@pytest.mark.parametrize("variant,kw,match", [
    ("nodot", dict(kt=128, tile=256), "kt >= tile"),
    ("int8", dict(kt=100, tile=128), "kt must be"),
    ("bf16", dict(kt=512, tile=192), "tile must be"),
])
def test_operands_the_kernels_do_not_take_are_refused(variant, kw, match):
    w, Bi, Bj = kernel_sweep.operands(variant, S, P, "cpu")
    C = torch.zeros((S, S), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        sweep.KERNELS[variant](w, Bi, Bj, C, **kw)
    with pytest.raises(ValueError, match="operands"):
        sweep.KERNELS["dotonly"](w, Bi, Bj, C, kt=512, tile=128)


@pytest.mark.parametrize("variant", ["int8", "nodot", "dotonly_s8",
                                     "dotonly", "dotonly_T"])
def test_run_variant_record(variant):
    rec = kernel_sweep.run_variant(variant, S, P, 512, 128, n1=1, n2=2,
                                   device="cpu", out=None)
    nt = S // 128
    cells = nt * (nt + 1) // 2 * 128 * 128
    assert {"variant", "S", "P", "kt", "tile", "device", "per_call_ms",
            "tops", "chain_lens", "ops", "bytes", "bound_ms", "bound_by",
            "library_ms", "library_op"} <= set(rec)
    assert rec["chain_lens"] == [1, 2] and rec["device"] == "cpu"
    assert rec["ops"] == (0.0 if variant == "nodot" else 2.0 * cells * P)
    assert rec["bound_by"] in ("bytes", "operations") and rec["bound_ms"] > 0
    assert rec["library_ms"] is None            # timed on a card only
    assert "library_error" not in rec
    if variant.startswith("dotonly"):
        op = rec["library_op"]
        assert op.startswith("torch._int_mm" if variant == "dotonly_s8"
                             else "torch.mm") and "full S x S" in op
    else:
        assert rec["library_op"] is None


@pytest.mark.parametrize("blocks,k_blocks,n_sm,want", [
    (136, 256, 132, 16),     # the tool's defaults: S 2,048, P 2^17, kt 512
    (136, 2048, 132, 13),    # bf16's: P 2^20, 2,212 K blocks against 2,110
    (10, 16, 132, 8),        # phase 23a's S 512, P 8,192: one wave of 80
    (1, 1, 132, 1),          # one K block: no split
    (10, 5, 132, 5),         # an odd number of K blocks, one each
    (528, 256, 132, 1),      # output blocks alone fill the card
])
def test_dot_splits_fill_the_card(blocks, k_blocks, n_sm, want):
    z = sweep.dot_splits(blocks, k_blocks, n_sm)
    assert z == want and 1 <= z <= k_blocks
    waves = -(-blocks * z // n_sm) * -(-k_blocks // z)
    assert waves <= max(sweep.SPLIT_SLACK * blocks * k_blocks / n_sm,
                        min(-(-blocks * y // n_sm) * -(-k_blocks // y)
                            for y in range(1, k_blocks + 1)))


def test_k_splits_is_checked_and_leaves_the_sums_alone():
    rng = np.random.default_rng(9)
    C0 = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(S, S),
                                       dtype=np.int64).astype(np.int32))
    assert set(sweep.SPLIT) == {"bf16", "bf16_ns", "nodot", "dotonly",
                                "dotonly_T"}
    assert sweep.PACKED_BF16 == ("bf16", "bf16_ns")
    assert sweep.UNPACKED_BF16 == ("dotonly", "dotonly_T")
    for v in ("dotonly", *sweep.PACKED_BF16, "nodot"):
        w, Bi, Bj = kernel_sweep.operands(v, S, P, "cpu", seed=9)
        if v == "dotonly":
            Bi = torch.from_numpy(rng.choice(HALVES, size=(P, S))) \
                .to(torch.bfloat16)
        else:
            Bj = torch.from_numpy(rng.integers(0, 256, size=(P // 8, S),
                                               dtype=np.uint8))
        want = sweep.plain(v, w, Bi, Bj, C0.clone(), kt=512, tile=128)
        assert not torch.equal(want, C0)
        for z in (1, 3, P // 512):
            got = sweep.KERNELS[v](w, Bi, Bj, C0.clone(), kt=512,
                                   tile=128, k_splits=z)
            assert torch.equal(got, want)
        for bad in (0, P // 512 + 1, 2.0):
            with pytest.raises(ValueError, match="k_splits"):
                sweep.KERNELS[v](w, Bi, Bj, C0.clone(), kt=512,
                                 tile=128, k_splits=bad)
    for v in ("int8", "dotonly_s8"):
        w8, B8, _ = kernel_sweep.operands(v, S, P, "cpu")
        with pytest.raises(ValueError, match="k_splits"):
            sweep.KERNELS[v](w8, B8, B8, C0.clone(), kt=512,
                             tile=128, k_splits=1)


def _random_db(S_db=300, n_pat=3000, max_w=1 << 12, seed=2):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 40, size=n_pat)
    offs = np.zeros(n_pat + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    sids = np.concatenate([np.sort(rng.choice(S_db, size=k, replace=False))
                           for k in lens]).astype(np.uint32)
    w = rng.integers(1, max_w, size=n_pat).astype(np.uint32)
    return KmerPatternDb(kmer_length=18,
                         sample_names=[f"s{i}" for i in range(S_db)],
                         sample_kmer_counts=np.zeros(S_db, np.uint32),
                         pattern_offsets=offs, pattern_sample_ids=sids,
                         pattern_num_kmers=w)


def _gram_of(db, pids, S_pad):
    """The host Gram of the patterns pids, padded to S_pad."""
    sub_offs = np.zeros(pids.size + 1, dtype=np.int64)
    lens = np.diff(db.pattern_offsets)[pids]
    np.cumsum(lens, out=sub_offs[1:])
    sids = np.concatenate([db.pattern_sample_ids[db.pattern_offsets[p]:
                                                 db.pattern_offsets[p + 1]]
                           for p in pids])
    out = np.zeros((S_pad, S_pad), dtype=np.uint32)
    out[:db.n_samples, :db.n_samples] = native.a2a_dense(
        sub_offs, sids, db.pattern_num_kmers[pids], db.n_samples)
    return out


@pytest.mark.skipif(not native.available, reason="no native host runtime")
@pytest.mark.parametrize("resident_mb", [None, "0"])
def test_kernel_bench_chain_is_n_times_the_lower_gram(monkeypatch,
                                                      resident_mb):
    db = _random_db()
    if resident_mb is not None:
        monkeypatch.setenv("KMERDB_A2A_RESIDENT_MB", resident_mb)
    _, kt, tile, S_pad = device_a2a._geometry(db.n_samples)
    groups = device_a2a._bench_groups(db, kt, S_pad, torch.device("cpu"))
    light, heavy, _ = device_a2a._limb_split(db.pattern_num_kmers)
    # a zero budget keeps one K block of each class, as kmerdb_tpu does
    keep = (light, heavy) if resident_mb is None \
        else (light[:kt], heavy[:kt])
    assert [Bp.shape[0] * 8 for Bp, _, _ in groups] == \
        [-(-p.size // kt) * kt for p in keep]
    n = 3
    C = device_a2a._bench_chain(groups, S_pad, n, kt, tile,
                                torch.device("cpu")).numpy().view(np.uint32)
    want = _gram_of(db, np.concatenate(keep), S_pad) * np.uint32(n)
    band = np.arange(S_pad) // tile
    lower = band[:, None] >= band[None, :]
    np.testing.assert_array_equal(C[lower], want[lower])
    assert not C[~lower].any()


@pytest.mark.skipif(not native.available, reason="no native host runtime")
def test_kernel_bench_record_follows_the_geometry_knobs(monkeypatch):
    db = _random_db()
    monkeypatch.setenv("KMERDB_A2A_KT", "512")
    monkeypatch.setenv("KMERDB_A2A_TILE", "256")
    rec = device_a2a.kernel_bench(db, n1=1, n2=2, device="cpu")
    assert (rec["kt"], rec["tile"], rec["S_pad"]) == (512, 256, 512)
    assert rec["kernel_chain_lens"] == [1, 2] and rec["groups"] == 2
    assert rec["benched_rows"] % 512 == 0 and rec["kernel_ops_per_pass"] > 0
    assert rec["int8_peak_share_pct"] is None   # no share of a CPU


@pytest.mark.skipif(not native.available, reason="no native host runtime")
def test_kernel_bench_runs_the_bf16_engine(monkeypatch):
    """Under KMERDB_A2A_ENGINE=bf16 kernel_bench times the bf16 triangle
    (engine="bf16" at every call) at kmerdb_tpu's bf16 geometry, the knobs
    not applied, over the 8-bit light class, and its chain is n times the
    lower Gram; its share would be of the bf16 peak."""
    db = _random_db()
    monkeypatch.setenv("KMERDB_A2A_ENGINE", "bf16")
    monkeypatch.setenv("KMERDB_A2A_KT", "1024")
    engines = []
    real = device_a2a.gram.gram_u32_pk_tri
    monkeypatch.setattr(device_a2a.gram, "gram_u32_pk_tri",
                        lambda *a, **kw: engines.append(kw["engine"])
                        or real(*a, **kw))
    rec = device_a2a.kernel_bench(db, n1=1, n2=2, device="cpu")
    assert (rec["engine"], rec["kt"], rec["tile"]) == ("bf16", 512, 128)
    assert engines == ["bf16"] * 3 * rec["groups"]
    assert rec["bf16_peak_share_pct"] is None   # no share of a CPU
    light, heavy, _ = device_a2a._limb_split(db.pattern_num_kmers, 8)
    groups = device_a2a._bench_groups(db, 512, rec["S_pad"],
                                      torch.device("cpu"), "bf16")
    assert [Bp.shape[0] * 8 for Bp, _, _ in groups] == \
        [-(-p.size // 512) * 512 for p in (light, heavy) if p.size]
    C = device_a2a._bench_chain(groups, rec["S_pad"], 2, 512, 128,
                                torch.device("cpu"), "bf16")
    want = _gram_of(db, np.concatenate([light, heavy]), rec["S_pad"]) \
        * np.uint32(2)
    band = np.arange(rec["S_pad"]) // 128
    lower = band[:, None] >= band[None, :]
    np.testing.assert_array_equal(C.numpy().view(np.uint32)[lower],
                                  want[lower])


@pytest.mark.skipif(not native.available, reason="no native host runtime")
@pytest.mark.parametrize("before", [None, "1024"])
def test_sweep_on_db_restores_the_knobs(tmp_path, monkeypatch, before):
    from kmerdb_tpu_torch.io import dbfile
    from kmerdb_tpu_torch.models import builder
    rng = np.random.default_rng(4)
    pool = rng.integers(0, 1 << 40, size=3000, dtype=np.uint64)
    db = builder.add_samples(
        KmerPatternDb(kmer_length=18, fraction=1.0, alphabet_name="nt"),
        [(f"s{i}", np.unique(rng.choice(pool, size=400, replace=False)))
         for i in range(20)])
    path = str(tmp_path / "x.db")
    dbfile.save_db(db, path)
    for var in kernel_sweep.GEOMETRY_KNOBS:
        if before is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, before)
    out = tmp_path / "sweep.jsonl"
    rows = kernel_sweep.sweep_on_db(path, [256, 512], [128, 256],
                                    device="cpu", out=str(out))
    assert [(r["kt"], r["tile"]) for r in rows] == \
        [(256, 128), (256, 256), (512, 128), (512, 256)]
    assert len(out.read_text().splitlines()) == 4
    for var in kernel_sweep.GEOMETRY_KNOBS:
        assert os.environ.get(var) == before


def test_tool_without_cuda_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert kernel_sweep.main(["int8"]) != 0
    assert "CUDA" in capsys.readouterr().err


def test_rate_tool_without_cuda_exits_nonzero(capsys):
    from kmerdb_tpu_torch.tools import gram_u8_rate
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert gram_u8_rate.main([]) == 1
    assert "CUDA" in capsys.readouterr().err
    assert gram_u8_rate.main(["--S"]) == 2


def test_rate_tool_reads_the_block_kernels_from_ptxas():
    from kmerdb_tpu_torch.tools import gram_u8_rate
    names = ("_ZN12_GLOBAL__N_115gram_u32_kernelILb1EEEvPKhPKjPjlli",
             "_ZN12_GLOBAL__N_118gram_pk_tri_kernelEPKhPKjPjlliii",
             "_ZN12_GLOBAL__N_115sweep_s8_kernelEPKaS1_Pjlli")
    log = "".join(
        f"ptxas info    : Compiling entry function '{n}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {n}\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {r} registers, used 1 barriers\n"
        for n, r in zip(names, (121, 118, 120)))
    got = gram_u8_rate._ptxas(log)
    assert [ln for ln in got if not ln.startswith(" ")] == [names[0], names[2]]
    assert sum("Used 121 registers" in ln for ln in got) == 1
    assert not any("118" in ln for ln in got)


#: (times by (variant, k_splits), the split's records): nodot beside both
#: packed variants; beside bf16 alone, one split of two; nodot alone;
#: beside bf16_ns alone
STAGING_CASES = [
    ({("bf16", 13): (9.5, True), ("nodot", 13): (7.5, True),
      ("bf16_ns", 13): (8.5, True), ("bf16", 1): (20.0, False),
      ("dotonly", 16): (1.8, True)},
     [{"split": "bf16", "k_splits": 13, "planned": True, "nodot_ms": 7.5,
       "bf16_ms": 9.5, "less_nodot_ms": 2.0, "nodot_share": 7.5 / 9.5},
      {"split": "bf16_ns", "k_splits": 13, "planned": True, "nodot_ms": 7.5,
       "bf16_ns_ms": 8.5, "less_nodot_ms": 1.0, "nodot_share": 7.5 / 8.5}]),
    ({("bf16", 2): (16.0, False), ("nodot", 2): (12.0, False),
      ("bf16", 8): (10.0, True), ("nodot", 4): (6.0, False)},
     [{"split": "bf16", "k_splits": 2, "planned": False, "nodot_ms": 12.0,
       "bf16_ms": 16.0, "less_nodot_ms": 4.0, "nodot_share": 0.75}]),
    ({("nodot", 13): (7.5, True)}, []),
    ({("bf16_ns", 4): (10.0, False), ("nodot", 4): (8.0, False)},
     [{"split": "bf16_ns", "k_splits": 4, "planned": False, "nodot_ms": 8.0,
       "bf16_ns_ms": 10.0, "less_nodot_ms": 2.0, "nodot_share": 0.8}]),
]


@pytest.mark.parametrize("ms,want", STAGING_CASES,
                         ids=["both", "one-split", "nodot-alone",
                              "bf16_ns-alone"])
def test_bf16_rate_tool_splits_the_packed_block(ms, want):
    """gram_bf16_rate's staging split: at each k_splits where nodot ran
    beside bf16 or bf16_ns, nodot's time, the whole, and their
    difference; nothing where they ran at different k_splits."""
    from kmerdb_tpu_torch.tools import gram_bf16_rate
    assert gram_bf16_rate.staging_split(ms) == want


def test_sass_reader_takes_each_kernels_instructions(monkeypatch):
    """_cuda.sass_opcodes reads cuobjdump -sass: the instructions, with
    their modifiers and without predicates, of the kernels whose mangled
    names hold the names asked for."""
    from kmerdb_tpu_torch.ops import _cuda
    dump = (
        "\t\tFunction : _ZN12_GLOBAL__N_123gram_pk_tri_bf16_kernelEPKh\n"
        "\t.headerflags\t@\"EF_CUDA_SM90\"\n"
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;  /* 0x0 */\n"
        "        /*0010*/                   HGMMA.64x128x16.F32.BF16 R24, "
        "gdesc[UR4], RZ, !UPT ;\n"
        "        /*0020*/              @!P0 BRA 0x50 ;\n"
        "\t\tFunction : _ZN12_GLOBAL__N_115sweep_s8_kernelEPKa\n"
        "        /*0000*/              @UP1 LDSM.16.M88.4 R4, [R2] ;\n"
        "        /*0010*/                   IMMA.16832.S8.S8 R8, R4, R6, R8 ;\n")
    monkeypatch.setattr(_cuda, "_tool", lambda name: name)
    monkeypatch.setattr(_cuda.subprocess, "run", lambda *a, **kw:
                        types.SimpleNamespace(stdout=dump))
    got = _cuda.sass_opcodes(["gram_pk_tri_bf16_kernel", "sweep_s8_kernel",
                              "absent_kernel"])
    assert got == {"gram_pk_tri_bf16_kernel":
                   {"LDC", "HGMMA.64x128x16.F32.BF16", "BRA"},
                   "sweep_s8_kernel": {"LDSM.16.M88.4", "IMMA.16832.S8.S8"}}


def test_bf16_rate_tool_without_cuda_exits_nonzero(capsys):
    from kmerdb_tpu_torch.tools import gram_bf16_rate
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert gram_bf16_rate.main(["--variants", "bf16,bf16_ns"]) == 1
    assert "CUDA" in capsys.readouterr().err
