"""The ICTV prefilter deployment on the CPU: `build -k 25` of a clade
collection and `all2all -sparse -min num-kmers:11` on the streamed route.

The build keeps a batch open past 1,024 samples until it holds a k-mer
budget (cli/consoles._BUILD_KMERS), and never closes one earlier; the
database bytes do not depend on the batches.
Here the port's build is held, byte for byte, to the earlier rule (kept
below as parent_build) and to kmerdb_tpu's build, in many batches, with a
sample that adds no k-mer, under -extend, KMERDB_BUILD_DEVICE=1 and
-mesh; and the outputs of every mode on the port's database to
kmerdb_tpu's.  The streamed sparse route's CSV is held to the benchmark's
plain reference (portbench/reference), with its spans and tile counters;
the four readers of the benchmark's ICTV cell read synthetic runs.
"""

import json
import math
import pathlib
import types

import pytest
import torch

from kmerdb_tpu.cli.main import main as jax_main
from kmerdb_tpu_torch import _torchinit
from kmerdb_tpu_torch.cli import consoles, params
from kmerdb_tpu_torch.cli.loader import iter_samples
from kmerdb_tpu_torch.cli.main import main as port_main
from kmerdb_tpu_torch.io import dbfile
from kmerdb_tpu_torch.models import builder
from kmerdb_tpu_torch.models.database import KmerPatternDb
from kmerdb_tpu_torch.ops import device_a2a
from kmerdb_tpu_torch.utils import native, trace
from portbench import corpus, harness, registry, sparse_roofline

pytestmark = pytest.mark.skipif(not native.available,
                                reason="no native host runtime")

#: a small clade collection: 300 genomes of 1,500 bp in clades of 1..48
SPEC = {"kind": "clades", "n_samples": 300, "genome_len": 1500,
        "branch_rate": 0.004, "clade_exponent": 2.0, "max_clade": 48,
        "sizes_seed": 607}
SEED = 2**31 + 24
ICTV = ["-sparse", "-min", "num-kmers:11"]


def parent_build(argv, batch_samples: int) -> None:
    """`build <argv>` as it was before the k-mer budget: the loader's
    samples added to the database every `batch_samples` samples."""
    p = params.parse_args(["build", *argv])
    samples_arg, out = p.files
    db = KmerPatternDb(kmer_length=0, fraction=p.fraction,
                       start_fraction=0.0, alphabet_name=p.alphabet_name)
    batch = []
    for s in iter_samples(samples_arg, p.input_format, p.kmer_length,
                          p.fraction, p.fraction_start, p.alphabet_name,
                          p.multisample_fasta, num_threads=1):
        if db.kmer_length == 0:
            db.kmer_length, db.fraction = s.kmer_length, s.fraction
        batch.append((s.name, s.kmers))
        if len(batch) >= batch_samples:
            db = builder.add_samples(db, batch)
            batch = []
    if batch or db.n_samples == 0:
        db = builder.add_samples(db, batch)
    dbfile.save_db(db, out)


def _batches() -> int:
    """The last call's count of add_samples batches."""
    return trace.history()[-1]["counters"]["build.batches"]


@pytest.fixture(scope="module")
def clades(tmp_path_factory):
    """(dir, the corpus list, the list with a genome shorter than k in its
    middle, the port's database of the latter, its bytes by the earlier
    rule)."""
    d = tmp_path_factory.mktemp("torch_ictv")
    lst = corpus.write(SPEC, SEED, str(d / "corpus"))
    entries = pathlib.Path(lst).read_text().split()
    (d / "corpus" / "short.fasta").write_text(">short\nACGTACGTAC\n")
    entries.insert(150, str(d / "corpus" / "short"))
    with_short = d / "with_short.list"
    with_short.write_text("\n".join(entries) + "\n")
    db = d / "port.db"
    assert port_main(["build", "-t", "1", "-k", "25", str(with_short),
                      str(db)]) == 0
    assert _batches() == 1
    parent_build(["-t", "1", "-k", "25", str(with_short),
                  str(d / "parent.db")], 1024)
    return d, lst, str(with_short), str(db), (d / "parent.db").read_bytes()


def test_default_build_is_the_parents_bytes(clades):
    d, _, with_short, db, parent = clades
    assert pathlib.Path(db).read_bytes() == parent
    jdb = d / "jax.db"
    assert jax_main(["build", "-t", "1", "-k", "25", with_short,
                     str(jdb)]) == 0
    assert jdb.read_bytes() == parent


@pytest.mark.parametrize("batch", [3, 17, 64])
def test_many_batches_write_the_same_bytes(clades, batch, monkeypatch,
                                           tmp_path):
    """KMERDB_BUILD_BATCH stays the override: so many samples a batch,
    each batch counted; the bytes are the earlier rule's at that batch
    and at 1,024."""
    _, _, with_short, _, parent = clades
    monkeypatch.setenv("KMERDB_BUILD_BATCH", str(batch))
    out = tmp_path / "db"
    assert port_main(["build", "-t", "1", "-k", "25", with_short,
                      str(out)]) == 0
    assert _batches() == math.ceil(301 / batch)
    assert out.read_bytes() == parent
    parent_build(["-t", "1", "-k", "25", with_short, str(tmp_path / "p")],
                 batch)
    assert (tmp_path / "p").read_bytes() == parent


@pytest.mark.parametrize("budget,min_samples,max_samples",
                         [(20_000, 1, 16384), (1, 1, 16384), (10**9, 1, 40),
                          (1, 50, 16384), (20_000, 50, 16384)])
def test_kmer_budget_closes_the_batches(clades, budget, min_samples,
                                        max_samples, monkeypatch, tmp_path):
    """A batch closes once it numbers _BUILD_MAX_SAMPLES, or numbers
    _BUILD_MIN_SAMPLES and its samples hold _BUILD_KMERS k-mers, and never
    before the least: the counter build.batches shows how many there were,
    and the bytes do not change.  Small partitions make the merge cut
    every batch into several key ranges."""
    _, _, with_short, _, parent = clades
    monkeypatch.setattr(consoles, "_BUILD_KMERS", budget)
    monkeypatch.setattr(consoles, "_BUILD_MIN_SAMPLES", min_samples)
    monkeypatch.setattr(consoles, "_BUILD_MAX_SAMPLES", max_samples)
    monkeypatch.setattr(builder, "_PARTITION_ELEMS", 50_000)
    sizes = [s.kmers.size for s in iter_samples(
        with_short, params.GENOME, 25, 1.0, 0.0, "nt", False,
        num_threads=1)]
    want, n, k = 0, 0, 0
    for size in sizes:
        n, k = n + 1, k + size
        if n >= max_samples or (n >= min_samples and k >= budget):
            want, n, k = want + 1, 0, 0
    want += n > 0
    out = tmp_path / "db"
    assert port_main(["build", "-t", "1", "-k", "25", with_short,
                      str(out)]) == 0
    assert _batches() == want > 1
    assert want <= math.ceil(301 / min_samples)
    assert out.read_bytes() == parent


@pytest.mark.parametrize("batch", ["", "7"])
def test_extend_writes_the_same_bytes(clades, batch, monkeypatch, tmp_path):
    """build of the first 120 entries, then -extend by the rest: the bytes
    of the one build, and kmerdb_tpu's under the same steps."""
    _, _, with_short, _, parent = clades
    if batch:
        monkeypatch.setenv("KMERDB_BUILD_BATCH", batch)
    entries = pathlib.Path(with_short).read_text().split()
    halves = []
    for i, part in enumerate((entries[:120], entries[120:])):
        halves.append(tmp_path / f"half{i}.list")
        halves[-1].write_text("\n".join(part) + "\n")
    outs = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        db = tmp_path / f"{name}.db"
        assert main(["build", "-t", "1", "-k", "25", str(halves[0]),
                     str(db)]) == 0
        assert main(["build", "-t", "1", "-extend", str(halves[1]),
                     str(db)]) == 0
        outs[name] = db.read_bytes()
    assert outs["port"] == outs["jax"] == parent


@pytest.mark.parametrize("how", ["device_build", "mesh"])
def test_device_and_mesh_builds_write_the_same_bytes(clades, how,
                                                     monkeypatch, tmp_path):
    """KMERDB_BUILD_DEVICE=1 (the card patched to the CPU) and -mesh 3 (CPU
    slots) take the same batches, in one batch and in several."""
    _, _, with_short, _, parent = clades
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))
    monkeypatch.setattr(_torchinit, "devices",
                        lambda: [torch.device("cpu")] * 8)
    opts = ["-mesh", "3"] if how == "mesh" else []
    if how == "device_build":
        monkeypatch.setenv("KMERDB_BUILD_DEVICE", "1")
    monkeypatch.setattr(consoles, "_BUILD_MIN_SAMPLES", 1)
    for budget, batches in ((1 << 28, 1), (200_000, None)):
        monkeypatch.setattr(consoles, "_BUILD_KMERS", budget)
        out = tmp_path / f"{budget}.db"
        assert port_main(["build", "-t", "1", *opts, "-k", "25", with_short,
                          str(out)]) == 0
        assert _batches() == batches if batches else _batches() > 1
        assert out.read_bytes() == parent


@pytest.fixture(scope="module")
def jax_db(clades):
    """kmerdb_tpu's database of the list, built at its 1,024 samples a
    batch, and a list of every seventh entry as new2all's queries."""
    d, _, with_short, _, _ = clades
    jdb = d / "jax-out.db"
    assert jax_main(["build", "-t", "1", "-k", "25", with_short,
                     str(jdb)]) == 0
    entries = pathlib.Path(with_short).read_text().split()
    (d / "queries.list").write_text("\n".join(entries[::7]) + "\n")
    return str(jdb)


def _mode_argv(mode, db, d, out):
    queries = str(d / "queries.list")
    return {"all2all": ["all2all", db, out],
            "all2all-sparse": ["all2all", *ICTV, db, out],
            "new2all": ["new2all", "-t", "1", *ICTV, db, queries, out],
            "new2all-dense": ["new2all", "-t", "1", db, queries, out],
            "distance": ["distance", "mash", db + ".csv", out]}[mode]


@pytest.mark.parametrize("mode", ["all2all", "all2all-sparse", "new2all",
                                  "new2all-dense", "distance"])
def test_every_mode_on_the_new_database_matches_jax(clades, jax_db, mode,
                                                    monkeypatch):
    """all2all dense and sparse, new2all sparse and dense, and distance
    over each package's all2all table, on the port's database, write
    kmerdb_tpu's bytes on its own database."""
    d, port_db = clades[0], clades[3]
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "0")
    monkeypatch.setenv("KMERDB_N2A_DEVICE", "0")
    outs = []
    for main, db in ((port_main, port_db), (jax_main, jax_db)):
        if mode == "distance":
            assert main(["all2all", db, db + ".csv"]) == 0
        out = f"{db}.{mode}"
        assert main(_mode_argv(mode, db, d, out)) == 0
        outs.append(pathlib.Path(out).read_bytes())
    assert outs[0] == outs[1]


# the streamed sparse route, by default, as the benchmark's cell runs it

def test_streamed_ictv_rows_match_the_reference(clades, monkeypatch,
                                                tmp_path):
    """all2all -sparse -min num-kmers:11 of 300 samples on the default
    streamed route (STREAM_MIN_SAMPLES lowered, the card patched to the
    CPU), with 256-row stripes of a 384-row square so that the last
    stripe overlaps the first: every line equals the reference's, each
    sparse row's filter is a rows.filter part, each 128 x 128 tile counts
    once and the counters equal last_stats."""
    d, lst, _, _, _ = clades
    db = tmp_path / "db"
    assert port_main(["build", "-t", "1", "-k", "25", lst, str(db)]) == 0
    monkeypatch.setenv("KMERDB_COST_CALIBRATE", "0")
    monkeypatch.setattr(consoles, "STREAM_MIN_SAMPLES", 200)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))
    monkeypatch.setattr(device_a2a, "STRIPE_BYTES", 256 * 384 * 4)
    out = tmp_path / "ictv.csv"
    device_a2a.last_stats.clear()
    assert port_main(["all2all", *ICTV, str(db), str(out)]) == 0
    st, rec = device_a2a.last_stats, trace.history()[-1]
    assert st["streamed"] and st["stripe_rows"] == 256 and st["S_pad"] == 384

    S = SPEC["n_samples"]
    config = {"build": ["-k", "25"]}
    traffic = registry.traffic("a2a-ictv")
    assert traffic["args"] == ICTV
    want = harness.expected_lines(config, traffic, lst, list(range(S)),
                                  "cpu")
    got = out.read_text().splitlines(keepends=True)
    assert len(got) == S + 2
    assert {no: got[no] for no in want} == want
    # the clades share k-mers inside themselves alone: rows keep few cells
    assert 0 < sum(line.count(":") for line in got) < S * (S - 1) // 4

    spans, counters = rec["spans"], rec["counters"]
    assert spans["rows.filter"]["n"] == S == counters["rows"]
    assert spans["rows.filter"]["wall_s"] > 0
    assert spans["rows.format"]["wall_s"] + spans["rows.write"]["wall_s"] \
        + spans["rows.filter"]["wall_s"] <= spans["rows"]["wall_s"]
    sp = st["sparse_pull"]
    assert counters["device.tiles_total"] == sp["tiles_total"] \
        == (384 // 128) ** 2
    assert counters["device.tiles_pulled"] == sp["tiles_pulled"]
    assert counters["device.dense_fallbacks"] == sp["dense_fallbacks"] == 0
    assert 0 < sp["tiles_pulled"] < sp["tiles_total"]


def test_dense_rows_have_no_filter_part(clades, monkeypatch, tmp_path):
    """The dense route reads no filter clock and counts no tiles."""
    _, _, _, db, _ = clades
    monkeypatch.setenv("KMERDB_A2A_STREAM", "1")
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))
    assert port_main(["all2all", db, str(tmp_path / "dense.csv")]) == 0
    rec = trace.history()[-1]
    assert "rows.filter" not in rec["spans"]
    assert rec["counters"] == {"rows": 301}


# the benchmark's readers of the ICTV cell, on synthetic runs

READERS = ("row_filter_s", "tiles_pulled_pct", "sparse_pull_s",
           "filter_roofline_pct")


def _record(t0, spans, counters):
    return {"mode": "all2all", "t0": t0, "t1": t0 + 1.0, "rc": 0,
            "wall_s": 1.0, "unattributed_s": 0.0, "device": {},
            "spans": {k: dict(zip(trace.FIELDS, v))
                      for k, v in spans.items()},
            "counters": counters}


def _run(records, stats, monkeypatch, S=16896):
    """A run whose window made one call a record, its stats `stats`."""
    monkeypatch.setattr(trace, "history", lambda: list(records))
    calls = [{"t0": r["t0"], "t1": r["t1"], "stats": s}
             for r, s in zip(records, stats)]
    return types.SimpleNamespace(calls=calls, db={"S": S, "P": 10**6})


def test_readers_read_a_sparse_run(monkeypatch):
    """Two calls of 16,896 rows: the filter 0.4 and 0.6 s, 300 and 500 of
    the 132^2 tiles pulled, the card's filter 2 and 4 ms."""
    S, T = 16896, 132 ** 2
    recs = [_record(10.0 * i, {"rows": (3, 2.0, 0.1, 2.0),
                               "rows.filter": (S, filt, filt)},
                    {"rows": S, "device.tiles_pulled": pulled,
                     "device.tiles_total": T, "device.dense_fallbacks": 0})
            for i, (filt, pulled) in enumerate(((0.4, 300), (0.6, 500)))]
    stats = [{"filter_s": 0.002, "pull_s": 0.004, "sparse_pull": {}},
             {"filter_s": 0.004, "pull_s": 0.006, "sparse_pull": {}}]
    run = _run(recs, stats, monkeypatch)
    got = {m: registry.reader(m)(run) for m in READERS}
    assert got["row_filter_s"] == pytest.approx(0.5)
    assert got["tiles_pulled_pct"] == pytest.approx(100 * 800 / (2 * T))
    assert got["sparse_pull_s"] == pytest.approx(0.008)
    bound = sparse_roofline.filter_bound_s(S)
    assert got["filter_roofline_pct"] == pytest.approx(100 * bound / 0.003)
    assert 0 < got["filter_roofline_pct"] < 100


def test_readers_report_nothing_for_a_dense_run(monkeypatch):
    recs = [_record(0.0, {"rows": (3, 2.0, 0.1, 2.0),
                          "rows.format": (3, 1.0, 1.0)}, {"rows": 3})]
    stats = [{"gram_s": 1.0, "pull_s": 0.1, "fill_s": 0.1, "push_s": 0.1}]
    run = _run(recs, stats, monkeypatch)
    assert {m: registry.reader(m)(run) for m in READERS} == \
        dict.fromkeys(READERS)


@pytest.mark.parametrize("S,want_bytes", [
    (128, 4 * 128 * 127 // 2 + 4 * 128),
    (16896, 4 * 16896 * 16895 // 2 + 4 * 132 * 16896),
    (300, 4 * 300 * 299 // 2 + 4 * 3 * 300)])
def test_filter_bound_counts_the_triangle_and_tile_sums(S, want_bytes):
    assert sparse_roofline.filter_bytes(S) == want_bytes
    assert sparse_roofline.filter_bound_s(S) == \
        pytest.approx(want_bytes / 3.35e12)


def test_ictv_cell_is_in_the_benchmark():
    bench = registry.load_bench()
    cell = registry.workload(bench, "clades20k.a2a-ictv")
    assert cell["chips"] == 1 and cell["traffic"] == "a2a-ictv"
    config = registry.config(bench, cell["config"])
    assert config["corpus"]["kind"] == "clades" and \
        config["build"] == ["-k", "25"]
    for m in READERS:
        entry = next(e for e in bench["per_layer"] if e["name"] == m)
        assert entry["workloads"] == ["clades20k.a2a-ictv"]
        registry.reader(m)


@pytest.mark.parametrize("traffic", ["a2a-ictv", "a2a-dense"])
def test_harness_reads_the_ictv_metrics_of_a_traced_run(traffic, tmp_path,
                                                        monkeypatch):
    """A traced run of a tiny clade cell under each traffic, the device
    tier on the CPU on the streamed route: correct, and the ICTV cell's
    program readers read the sparse route (the CUDA-event ones need a
    card) and nothing under the dense traffic."""
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))
    monkeypatch.setenv("KMERDB_A2A_STREAM", "1")
    (tmp_path / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "build": ["-k", "25"], "corpus": SPEC}))
    real = registry.load_bench()
    bench = {"configs": [{"name": "tiny", "file": "tiny.json"}],
             "workloads": [{"name": "tiny.cell", "config": "tiny",
                            "traffic": traffic, "chips": 1}],
             "end_to_end": real["end_to_end"],
             "per_layer": real["per_layer"]}
    result, numbers = harness.run_cell(bench, "tiny.cell", SEED, 0.2, True,
                                       root=tmp_path,
                                       cache=tmp_path / "cache",
                                       ref_device="cpu")
    assert result["correct"], numbers
    m = {k: v["value"] for k, v in result["metrics"].items()}
    if traffic == "a2a-ictv":
        assert m["row_filter_s"] > 0
        assert 0 < m["tiles_pulled_pct"] < 100
    else:
        assert not set(READERS) & set(m)
