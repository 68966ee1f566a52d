"""A whole run of the harness on the CPU at a tiny size: the program's
streamed all2all (its kernels' plain versions), the sink, the reference and
the check.  Sound runs are correct; runs with the timed path broken
underneath, and the control, are not.  Without a card the command refuses
to run; nothing it or the reference loads is jax or kmerdb_tpu."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from kmerdb_tpu_torch import _torchinit
from kmerdb_tpu_torch.ops import gram
from portbench import control, harness, judge, registry

ROOT = registry.ROOT
CELLS = {"tree.dense": ("tiny-tree", "a2a-dense"),
         "clades.ictv": ("tiny-clades", "a2a-ictv")}
CONFIGS = {
    "tiny-tree": {"kind": "tree", "n_samples": 80, "genome_len": 3000,
                  "branch_rate": 0.004, "k": 18},
    "tiny-clades": {"kind": "clades", "n_samples": 80, "genome_len": 2000,
                    "branch_rate": 0.004, "clade_exponent": 2.0,
                    "max_clade": 24, "sizes_seed": 2, "k": 25},
}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A benchmark of the two tiny cells beside the real one's metrics."""
    root = tmp_path_factory.mktemp("bench")
    real = registry.load_bench()
    configs = []
    for name, spec in CONFIGS.items():
        spec = dict(spec)
        k = spec.pop("k")
        (root / f"{name}.json").write_text(json.dumps(
            {"name": name, "corpus": spec, "build": ["-k", str(k)]}))
        configs.append({"name": name, "file": f"{name}.json"})
    return root, {
        "configs": configs,
        "workloads": [{"name": c, "config": cfg, "traffic": t, "chips": 1}
                      for c, (cfg, t) in CELLS.items()],
        "end_to_end": real["end_to_end"], "per_layer": real["per_layer"]}


@pytest.fixture
def on_cpu(monkeypatch):
    """The program's device tier on the CPU, on the streamed route that the
    cells take on a card above 16,384 samples."""
    monkeypatch.setattr(_torchinit, "device", lambda: torch.device("cpu"))
    monkeypatch.setenv("KMERDB_A2A_STREAM", "1")


def _run(bench, cell, traced=False, seed=2**31 + 11):
    root, b = bench
    return harness.run_cell(b, cell, seed, 0.3, traced, root=root,
                            cache=root / "cache", ref_device="cpu")


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(bench, on_cpu, cell, traced):
    result, numbers = _run(bench, cell, traced)
    assert result["correct"], numbers
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    names = set(result["metrics"])
    if traced:
        assert {"writer_s", "fill_push_s", "load_s",
                "window_pairs_per_s"} <= names
        assert result["metrics"]["window_pairs_per_s"]["value"] > 0
    else:
        assert names == {"peak_dev_mib", "peak_host_mib", "setup_s"}


def _unchanged(real):
    def fault(Bp, wg, C, rt0, **kw):
        return None                      # the stripe is left as it was
    return fault


def _half_left_out(real):
    def fault(Bp, wg, C, rt0, **kw):
        half = Bp.clone()
        half[Bp.shape[0] // 2:] = 0      # half the patterns never counted
        return real(half, wg, C, rt0, **kw)
    return fault


def _answer_altered(real):
    def fault(Bp, wg, C, rt0, **kw):
        out = real(Bp, wg, C, rt0, **kw)
        # the last sample's count with the first, off by 100 (past the
        # sparse cells' bound of 11, where the true count is 0)
        row = CONFIGS["tiny-tree"]["n_samples"] - 1 - rt0 * kw["tile"]
        if 0 <= row < C.shape[0]:
            C[row, 0] += 100
        return out
    return fault


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", [_unchanged, _half_left_out,
                                   _answer_altered])
def test_broken_timed_path_is_not_correct(bench, on_cpu, monkeypatch, cell,
                                          fault):
    monkeypatch.setattr(gram, "gram_u32_pk_rows",
                        fault(gram.gram_u32_pk_rows))
    result, numbers = _run(bench, cell)
    assert not result["correct"]
    assert numbers["lines_wrong"] > 0 and numbers["cells_wrong"] > 0


def _unsampled_row(seed):
    n = CONFIGS["tiny-tree"]["n_samples"]
    return next(i for i in range(1, n) if i not in harness.check_rows(n, seed))


def _call_fails(monkeypatch, seed):
    def fault(*a, **kw):
        raise RuntimeError("planted")
    monkeypatch.setattr(gram, "gram_u32_pk_rows", fault)
    return "calls_failed"


def _later_calls_differ(monkeypatch, seed):
    """From the second call on, a row the check does not draw is off."""
    real, seen, row = gram.gram_u32_pk_rows, [], _unsampled_row(seed)

    def fault(Bp, wg, C, rt0, **kw):
        out = real(Bp, wg, C, rt0, **kw)
        if rt0 == 0:
            seen.append(1)
        local = row - rt0 * kw["tile"]
        if len(seen) > 1 and 0 <= local < C.shape[0]:
            C[local, 0] += 100
        return out
    monkeypatch.setattr(gram, "gram_u32_pk_rows", fault)
    return "calls_unlike_first"


def _row_dropped(monkeypatch, seed):
    """A row the check does not draw is never written."""
    from kmerdb_tpu_torch.cli import consoles
    real, row = consoles._emit_matrix_row, _unsampled_row(seed)

    def fault(ofs, name, cnt, values, i, filt):
        if i != row:
            real(ofs, name, cnt, values, i, filt)
    monkeypatch.setattr(consoles, "_emit_matrix_row", fault)
    return "line_count_off"


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", [_call_fails, _later_calls_differ,
                                   _row_dropped])
def test_structural_faults_are_not_correct(bench, on_cpu, monkeypatch, cell,
                                           fault):
    """Faults that the drawn rows cannot see: each is read by its own
    number, with the limit 0."""
    seed = 2**31 + 11
    number = fault(monkeypatch, seed)
    result, numbers = _run(bench, cell, seed=seed)
    assert not result["correct"]
    assert numbers[number] >= 1


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(bench, cell):
    root, b = bench
    numbers = control.control_numbers(b, cell, 5, root, root / "cache",
                                      "cpu")
    assert not judge.correct(numbers)
    assert numbers["cells_wrong"] > 0


def _script(code: str, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("KMERDB_")}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_without_a_card_no_result(tmp_path):
    """No card here: exit code 2, nothing on standard output.  In a copy
    that holds only BENCHMARK.json and the benchmark's folder, too."""
    copy = tmp_path / "bare"
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy)
    for cwd in (ROOT, copy):
        r = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "tree20k.a2a-dense", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300, env={k: v for k, v in os.environ.items()
                              if not k.startswith("KMERDB_")})
        assert r.returncode != 0 and r.stdout.strip() == "", r.stderr


_RUN_AND_LIST = """
import json, os, pathlib, sys
sys.path.insert(0, {root!r})
os.environ["KMERDB_A2A_STREAM"] = "1"
import torch
from kmerdb_tpu_torch import _torchinit
_torchinit.device = lambda: torch.device("cpu")
from portbench import harness
bench = json.loads({bench!r})
if __name__ == "__main__":
    res, _ = harness.run_cell(bench, "tree.dense", 3, 0.2, False,
                              root=pathlib.Path({tmp!r}),
                              cache=pathlib.Path({tmp!r}) / "cache")
    print(json.dumps({{"correct": res["correct"],
                      "forbidden": harness.forbidden_modules()}}))
"""

_REFERENCE_ONLY = """
import sys
sys.path.insert(0, {root!r})
from portbench.reference import counts, csvfmt
totals, c = counts.row_counts([{fasta!r}], 18, [0])
print(sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"jax", "jaxlib", "flax", "kmerdb_tpu", "kmerdb_tpu_torch"}}))
"""


def test_nothing_loads_jax_or_kmerdb_tpu(bench, tmp_path):
    root, b = bench
    r = _script(_RUN_AND_LIST.format(root=str(ROOT), bench=json.dumps(b),
                                     tmp=str(root)), tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["forbidden"] == []
    fasta = tmp_path / "one.fasta"
    fasta.write_text(">one\n" + "ACGTTGCA" * 10 + "\n")
    r = _script(_REFERENCE_ONLY.format(root=str(ROOT), fasta=str(fasta)),
                tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


@pytest.mark.cuda
def test_tiny_cells_on_the_card(bench):
    """On a card: the same tiny cells through the CUDA kernels (the
    streamed route forced: 80 samples), correct, and their controls not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    os.environ["KMERDB_A2A_STREAM"] = "1"
    try:
        for cell in CELLS:
            result, numbers = _run(bench, cell, traced=True)
            assert result["correct"], numbers
            assert result["device"]["busy_s"] > 0
            root, b = bench
            numbers = control.control_numbers(b, cell, 5, root,
                                              root / "cache", "cuda")
            assert not judge.correct(numbers)
    finally:
        del os.environ["KMERDB_A2A_STREAM"]
