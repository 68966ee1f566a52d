"""Configurations, mixes and metric readers are found by their names."""

import types

import pytest

from portbench import devtrace, judge, registry


def test_every_name_resolves():
    bench = registry.load_bench()
    for cfg in bench["configs"]:
        c = registry.config(bench, cfg["name"])
        assert c["name"] == cfg["name"]
        assert set(cfg["reduced"]) <= set(c)
    for w in bench["workloads"]:
        assert registry.workload(bench, w["name"]) is w
        t = registry.traffic(w["traffic"])
        assert t["mode"] and t["pairs"]
        for m in registry.per_layer(bench, w["name"]):
            assert callable(registry.reader(m["name"]))
        names = {m["name"] for m in registry.end_to_end(bench, w["name"])}
        assert "setup_s" in names and len(names) >= 2
    with pytest.raises(KeyError):
        registry.traffic("no-such-mix")
    with pytest.raises(KeyError):
        registry.reader("no_such_metric")
    with pytest.raises(KeyError):
        registry.workload(bench, "no.such.cell")


def test_per_layer_follows_the_moved_metric():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b"}],
             "per_layer": [{"name": "m1", "moves": "a"},
                           {"name": "m2", "moves": "b"},
                           {"name": "m3", "moves": "c"}]}
    for cell in ("x", "y"):
        assert [m["name"] for m in registry.end_to_end(bench, cell)] == \
            ["a", "b"]
        assert [m["name"] for m in registry.per_layer(bench, cell)] == \
            ["m1", "m2"]


def _run(**kw):
    base = dict(calls=[], spans=devtrace.Spans(), trace=None, db={})
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_readers_find_nothing_and_return_none():
    for m in registry.load_bench()["per_layer"]:
        assert registry.reader(m["name"])(_run()) is None


def test_readers_read():
    calls = [{"stats": {"handler_s": 2.0, "fill_s": 0.5, "push_s": 0.25,
                        "gram_s": 0.2}, "cpu_s": 3.0},
             {"stats": {"handler_s": 4.0, "fill_s": 0.5, "push_s": 0.75,
                        "gram_s": 0.2}, "cpu_s": 5.0}]
    spans = devtrace.Spans()
    spans.items += [("load", 1.0, 3.0), ("load", 5.0, 6.0)]
    run = _run(calls=calls, spans=spans, db={"P": 3, "S": 4},
               trace={"busy_s": 1.0, "window_s": 4.0}, pairs_per_call=6,
               window_s=3.0)
    r = {m: registry.reader(m)(run) for m in
         ("writer_s", "fill_push_s", "load_s", "gram_roofline_pct",
          "device_idle_pct", "call_cpu_s", "window_pairs_per_s")}
    assert r["writer_s"] == 3.0 and r["fill_push_s"] == 1.0
    assert r["call_cpu_s"] == 4.0 and r["window_pairs_per_s"] == 4.0
    assert r["load_s"] == 1.5 and r["device_idle_pct"] == 75.0
    assert r["gram_roofline_pct"] == pytest.approx(
        100 * max(60 / 1979e12, 53.5 / 3.35e12) / 0.2)


def test_trace_summary():
    ev = [{"name": devtrace.WINDOW, "cat": "user_annotation",
           "ts": 1000.0, "dur": 10_000.0},
          {"name": "k1", "cat": "kernel", "ts": 1000.0, "dur": 2000.0},
          {"name": "k1", "cat": "kernel", "ts": 2500.0, "dur": 1000.0},
          {"name": "cp", "cat": "gpu_memcpy", "ts": 9000.0, "dur": 4000.0}]
    spans = devtrace.Spans()
    # the window began at 0.5 s on the host clock: 1000 us on the trace's
    spans.items += [("writer", 0.5035, 0.5075), ("call", 0.4, 0.6)]
    s = devtrace.summarize(ev, 0.5, spans)
    assert s["window_s"] == pytest.approx(0.01)
    assert s["busy_s"] == pytest.approx(0.0025 + 0.002)
    assert s["device_ops"][0] == ["k1", pytest.approx(0.003)]
    assert s["idle_gaps"][0] == ["writer", pytest.approx(0.0055)]
    assert devtrace.summarize(ev[:1], 0.5, spans) is None


def test_judge_counts_cells():
    assert judge.cells_differing("a,1,2,3,\n", "a,1,2,4,\n") == 1
    assert judge.cells_differing("a,1,2:5,7:3,\n", "a,1,2:5,\n") == 1
    expected = {0: "h,\n", 2: "a,1,\n"}
    rep = {"crc32": 1, "bytes": 8, "lines": 3, "kept": {"0": "h,", "2": "a,2,"}}
    n = judge.judge(expected, 3, [{"rc": 0, "report": rep}])
    assert n["lines_wrong"] == 1 and n["cells_wrong"] == 1
    assert not judge.correct(n)
