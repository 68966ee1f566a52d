"""The port's call records (kmerdb_tpu_torch/utils/trace.py) on the CPU.

Each CLI call leaves one record: the spans and counters of its layers, the
device tier's last_stats read from the same spans, the spans as
torch.profiler annotations inside the call's, no torch on the host tier,
a bounded history, and the benchmark's readers of the records.  The
device tier runs its kernels' plain versions (``_torchinit.device``
patched to the CPU) on the streamed route (KMERDB_A2A_STREAM=1).
"""

import json
import os
import pathlib
import re
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from kmerdb_tpu_torch import _torchinit
from kmerdb_tpu_torch.cli.main import main
from kmerdb_tpu_torch.ops import device_a2a, fused
from kmerdb_tpu_torch.utils import native, trace
from portbench import registry

REPO = pathlib.Path(__file__).resolve().parents[1]
S = 300
#: the benchmark's readers of the records
READERS = ("load_read_s", "load_decode_s", "row_format_s", "row_write_s",
           "rows_cpu_share_pct", "call_unattributed_pct")

pytestmark = pytest.mark.skipif(not native.available,
                                reason="no native host runtime")


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """A database of S random 600 bp samples, k 14."""
    d = tmp_path_factory.mktemp("torch_trace")
    rng = np.random.default_rng(7)
    paths = []
    for i in range(S):
        f = d / f"s{i}.fasta"
        f.write_text(f">s{i}\n{''.join(rng.choice(list('ACGT'), size=600))}\n")
        paths.append(str(f))
    (d / "samples.list").write_text("\n".join(paths) + "\n")
    assert main(["build", "-t", "1", "-k", "14", str(d / "samples.list"),
                 str(d / "db")]) == 0
    return d, str(d / "db")


@pytest.fixture
def streamed(monkeypatch, tmp_path):
    """The device tier on the CPU, the streamed route forced.  No cost
    calibration: on a machine with a card it would probe the patched
    device, the CPU, as a card (the fused route commits to its tier
    first)."""
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))
    monkeypatch.setenv("KMERDB_A2A_STREAM", "1")
    monkeypatch.setenv("KMERDB_COST_CALIBRATE", "0")
    monkeypatch.setenv("KMERDB_COST_CACHE_DIR", str(tmp_path / "cost"))


def _call(argv) -> tuple:
    """(rc, the call's record, the caller's clock before and after)."""
    n = len(trace.history())
    t0 = time.perf_counter()
    rc = main(argv)
    t1 = time.perf_counter()
    hist = trace.history()
    assert len(hist) == min(n + 1, trace.HISTORY)
    return rc, hist[-1], t0, t1


@pytest.mark.parametrize("opts", [[], ["-sparse", "-min", "2"]],
                         ids=["dense", "sparse"])
def test_streamed_call_leaves_one_record(db, streamed, opts, tmp_path):
    d, path = db
    rc, rec, t0, t1 = _call(["all2all", *opts, path, str(tmp_path / "o")])
    assert rc == 0 and rec["rc"] == 0 and rec["mode"] == "all2all"
    assert t0 <= rec["t0"] <= rec["t1"] <= t1
    spans = rec["spans"]
    assert {"load", "load.read", "load.decode", "tier", "device",
            "device.fill", "device.push", "rows", "rows.format",
            "rows.write", "output"} <= set(spans)
    for name, s in spans.items():
        assert 0 <= s["self_s"] <= s["wall_s"] <= rec["wall_s"], name
        # the writer's parts are sums of the row loop's clock, no thread CPU
        assert set(s) == set(trace.FIELDS) - (
            {"cpu_s"} if name.startswith("rows.") else set()), name
    # the parts lie inside their spans
    assert spans["load.read"]["wall_s"] + spans["load.decode"]["wall_s"] \
        <= spans["load"]["wall_s"]
    parts = ("rows.format", "rows.write") + (("rows.filter",) if opts
                                            else ())
    assert sum(spans[p]["wall_s"] for p in parts) <= spans["rows"]["wall_s"]
    assert spans["output"]["n"] == 2
    assert spans["rows.format"]["n"] == S
    # a sparse row's filter is a part of its own; a dense row has none
    assert ("rows.filter" in spans) == bool(opts)
    if opts:
        assert spans["rows.filter"]["n"] == S
        # the sparse pull's tiles, each tile of the padded square once
        sp = device_a2a.last_stats["sparse_pull"]
        assert rec["counters"] == {
            "rows": S, **{"device." + k: v for k, v in sp.items()}}
        assert sp["tiles_total"] == (device_a2a.last_stats["S_pad"]
                                     // 128) ** 2
    else:
        assert rec["counters"] == {"rows": S}
    assert 0 <= rec["unattributed_s"] <= rec["wall_s"]
    json.dumps(rec)


def test_last_stats_come_from_the_record(db, streamed, tmp_path,
                                        monkeypatch):
    """The streamed route's last_stats hold the record's spans: handler_s
    the rows spans, fill_s and push_s device.fill and device.push, total_s
    the device span; no plan's flops on either route or in fused's."""
    _, path = db
    rc, rec, _, _ = _call(["all2all", path, str(tmp_path / "o")])
    st, spans = device_a2a.last_stats, rec["spans"]
    assert rc == 0 and st["streamed"]
    assert st["handler_s"] == spans["rows"]["wall_s"]
    assert st["fill_s"] == spans["device.fill"]["wall_s"]
    assert st["push_s"] == spans["device.push"]["wall_s"]
    assert st["total_s"] == spans["device"]["wall_s"]
    monkeypatch.setenv("KMERDB_A2A_STREAM", "0")
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "1")
    rc, rec, _, _ = _call(["all2all", path, str(tmp_path / "m")])
    assert rc == 0 and "streamed" not in device_a2a.last_stats
    assert device_a2a.last_stats["fill_s"] == \
        rec["spans"]["device.fill"]["wall_s"]
    assert "flops" not in device_a2a.last_stats
    assert (tmp_path / "m").read_bytes() == (tmp_path / "o").read_bytes()
    fused.last_stats.clear()
    monkeypatch.setenv("KMERDB_FUSED_DEVICE", "1")
    monkeypatch.setenv("KMERDB_FUSED_DEDUP", "0")
    assert main(["all2all", "-from-fasta", "-t", "1", "-k", "14",
                 str(pathlib.Path(path).parent / "samples.list"),
                 str(tmp_path / "f")]) == 0
    assert fused.last_stats["route"] == "raw"
    assert "flops" not in fused.last_stats
    assert (tmp_path / "f").read_bytes() == (tmp_path / "o").read_bytes()


def test_spans_are_annotations_inside_the_call(db, streamed, tmp_path):
    """Under a torch.profiler session the spans are user annotations of
    their names, each inside the call's, a dotted one inside its parent."""
    from torch.profiler import ProfilerActivity, profile
    _, path = db
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rc, rec, _, _ = _call(["all2all", path, str(tmp_path / "o")])
    assert rc == 0
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    (call,) = [e for e in ann if e["name"] == "call:all2all"]

    def inside(e, outer):
        return outer["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

    names = {"load", "load.read", "load.decode", "tier", "device",
             "device.fill", "device.push", "rows", "output"}
    assert names <= {e["name"] for e in ann}
    for e in ann:
        if e["name"] in names:
            assert inside(e, call), e
    (load,) = [e for e in ann if e["name"] == "load"]
    for e in ann:
        if e["name"] in ("load.read", "load.decode"):
            assert inside(e, load), e
    assert len([e for e in ann if e["name"] == "rows"]) == \
        rec["spans"]["rows"]["n"]


def test_host_tier_call_leaves_torch_unloaded(db, tmp_path):
    """A host-tier all2all in a fresh process records its spans without
    importing torch."""
    _, path = db
    code = ("import json, sys\n"
            "from kmerdb_tpu_torch.cli.main import main\n"
            "from kmerdb_tpu_torch.utils import trace\n"
            f"rc = main(['all2all', {path!r}, {str(tmp_path / 'o')!r}])\n"
            "print(json.dumps([rc, 'torch' in sys.modules,\n"
            "                  sorted(trace.history()[-1]['spans'])]))\n")
    env = dict(os.environ, KMERDB_A2A_DEVICE="0",
               PYTHONPATH=os.pathsep.join(filter(None, [
                   str(REPO), os.environ.get("PYTHONPATH")])))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rc, has_torch, spans = json.loads(r.stdout.splitlines()[-1])
    assert rc == 0 and not has_torch
    assert {"load", "tier", "host", "rows", "rows.format", "output"} <= \
        set(spans)


def test_history_keeps_the_last_64_records(db, tmp_path, monkeypatch):
    """70 calls (a failing one among them, rc 255) leave 64 records, the
    last ones, in order."""
    _, path = db
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "0")
    t = time.perf_counter()
    for i in range(70):
        rc = main(["all2all", path if i != 66 else str(tmp_path / "none"),
                   str(tmp_path / "o")])
        assert rc == (255 if i == 66 else 0)
    hist = trace.history()
    assert len(hist) == trace.HISTORY == 64
    assert all(r["t0"] > t for r in hist)
    assert [r["t0"] for r in hist] == sorted(r["t0"] for r in hist)
    assert [r["rc"] for r in hist[-4:]] == [255, 0, 0, 0]
    assert "load" in hist[-4]["spans"] and "rows" not in hist[-4]["spans"]


def test_timing_line_reads_the_build_spans(db, tmp_path, monkeypatch,
                                           capsys):
    """build under KMERDB_TIMING=1 prints its TIMING line from the build's
    spans, with kmerdb_tpu's meaning: ingest the sample loop with the
    batches added inside it, add the last batch alone, then the save."""
    d, _ = db
    monkeypatch.setenv("KMERDB_TIMING", "1")
    monkeypatch.setenv("KMERDB_BUILD_BATCH", "128")
    capsys.readouterr()
    rc, rec, _, _ = _call(["build", "-t", "1", "-k", "14",
                           str(d / "samples.list"), str(tmp_path / "db")])
    assert rc == 0
    line = re.search(r"TIMING ingest=(\S+)s add=(\S+)s save=(\S+)s\n",
                     capsys.readouterr().err)
    spans = rec["spans"]
    ingested = spans["build.ingest"]
    assert spans["build.add"]["n"] == 3
    assert line.group(1) == f"{ingested['wall_s']:.2f}"
    assert line.group(3) == f"{spans['build.save']['wall_s']:.2f}"
    # the adds inside the loop are the ingest's wall less its self seconds
    last_add = spans["build.add"]["wall_s"] - (ingested["wall_s"]
                                               - ingested["self_s"])
    assert abs(float(line.group(2)) - last_add) <= 0.0051
    assert (tmp_path / "db").read_bytes() == (d / "db").read_bytes()


def test_readers_read_the_window_calls_records(db, streamed, tmp_path):
    """The benchmark's six readers of the records: the mean over the
    records inside the window's calls, nothing for calls that made none."""
    _, path = db
    calls, recs = [], []
    _call(["all2all", path, str(tmp_path / "o")])      # a warm-up's
    for _ in range(3):
        rc, rec, t0, t1 = _call(["all2all", path, str(tmp_path / "o")])
        calls.append({"t0": t0, "t1": t1})
        recs.append(rec)
    run = types.SimpleNamespace(calls=calls)
    got = {m: registry.reader(m)(run) for m in READERS}

    def mean(f):
        return sum(f(r) for r in recs) / len(recs)

    assert got["load_read_s"] == mean(
        lambda r: r["spans"]["load.read"]["wall_s"])
    assert got["load_decode_s"] == mean(
        lambda r: r["spans"]["load.decode"]["wall_s"])
    assert got["row_format_s"] == mean(
        lambda r: r["spans"]["rows.format"]["wall_s"])
    assert got["row_write_s"] == mean(
        lambda r: r["spans"]["rows.write"]["wall_s"])
    assert got["rows_cpu_share_pct"] == pytest.approx(mean(
        lambda r: 100 * r["spans"]["rows"]["cpu_s"]
        / r["spans"]["rows"]["wall_s"]))
    assert 0 < got["rows_cpu_share_pct"]
    assert 0 <= got["call_unattributed_pct"] < 100
    before = types.SimpleNamespace(calls=[{"t0": 0.0, "t1": 1e-9}])
    for m in READERS:
        assert registry.reader(m)(before) is None
        assert registry.reader(m)(types.SimpleNamespace(calls=[])) is None


def test_event_seconds_reach_the_record_once():
    """trace.Events adds each span's device seconds to the open record
    once, however often its route reads them."""

    class Ev:
        def __init__(self, ms):
            self.ms = ms

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.ms - self.ms

    events = trace.Events(torch.device("cpu"))
    events.pairs += [("gram_s", Ev(0.0), Ev(250.0)),
                     ("pull_s", Ev(0.0), Ev(50.0))]
    with trace.collect() as got:
        assert events.seconds() == {"gram_s": 0.25, "pull_s": 0.05}
        assert events.seconds() == {"gram_s": 0.25, "pull_s": 0.05}
        events.pairs.append(("gram_s", Ev(0.0), Ev(500.0)))
        assert events.seconds() == {"gram_s": 0.75, "pull_s": 0.05}
    assert got.device == {"device.gram": 0.75, "device.pull": 0.05}
