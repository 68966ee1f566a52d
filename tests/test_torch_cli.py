"""CLI parity of kmerdb_tpu_torch with kmerdb_tpu on a small corpus.

Both packages run `build` and `all2all` (dense and -sparse) on the same
24-sample corpus.  The port's device tier runs on the CPU here, through
its kernels' plain versions (``_torchinit.device`` patched to the CPU);
kmerdb_tpu's runs its Pallas kernels in the interpreter.  Every output
must be byte-identical, whichever tier made it.
"""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from kmerdb_tpu.cli.main import main as jax_main
from kmerdb_tpu.utils import bench_corpus, native
from kmerdb_tpu_torch import _torchinit
from kmerdb_tpu_torch.cli.main import main as port_main
from kmerdb_tpu_torch.ops import device_a2a

REPO = pathlib.Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not native.available,
                                reason="no native host runtime")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    lst = bench_corpus.generate(str(d / "corpus"), n_samples=24,
                                genome_len=5000)
    jax_db, port_db = str(d / "jax.db"), str(d / "port.db")
    assert jax_main(["build", "-k", "18", lst, jax_db]) == 0
    assert port_main(["build", "-k", "18", lst, port_db]) == 0
    return d, lst, jax_db, port_db


def test_build_matches_jax(corpus):
    _, _, jax_db, port_db = corpus
    assert pathlib.Path(port_db).read_bytes() == \
        pathlib.Path(jax_db).read_bytes()


@pytest.mark.parametrize("opts", [[], ["-sparse", "-min", "jaccard:0.1"]],
                         ids=["dense", "sparse"])
def test_all2all_matches_jax_on_every_tier(corpus, opts, monkeypatch):
    d, _, jax_db, port_db = corpus
    outs = {}
    for tier in ("1", "0"):
        monkeypatch.setenv("KMERDB_A2A_DEVICE", tier)
        out = str(d / f"jax{tier}{len(opts)}.csv")
        assert jax_main(["all2all", *opts, jax_db, out]) == 0
        outs[f"jax{tier}"] = pathlib.Path(out).read_bytes()

        monkeypatch.setattr(_torchinit, "device",
                            lambda: torch.device("cpu"))
        device_a2a.last_stats.clear()
        out = str(d / f"port{tier}{len(opts)}.csv")
        assert port_main(["all2all", *opts, port_db, out]) == 0
        outs[f"port{tier}"] = pathlib.Path(out).read_bytes()
        assert bool(device_a2a.last_stats) == (tier == "1")
    assert len(set(outs.values())) == 1, \
        [k for k in outs if outs[k] != outs["jax0"]]


def test_distance_matches_jax(corpus, monkeypatch):
    d, _, jax_db, _ = corpus
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "0")
    table = str(d / "table.csv")
    assert jax_main(["all2all", jax_db, table]) == 0
    got, want = str(d / "port.mash"), str(d / "jax.mash")
    assert port_main(["distance", "mash", table, got]) == 0
    assert jax_main(["distance", "mash", table, want]) == 0
    assert pathlib.Path(got).read_bytes() == pathlib.Path(want).read_bytes()


@pytest.mark.parametrize("argv,env", [
    (["all2all-sp", "-from-fasta", "LIST", "OUT"], {}),
    (["all2all-sp", "-from-fasta", "-mesh", "2", "LIST", "OUT"], {}),
    (["new2all", "-mesh", "2", "DB", "LIST", "OUT"],
     {"KMERDB_COORD": "localhost:1234"}),
    (["new2all", "DB", "LIST", "OUT"], {"KMERDB_DEVICE_INGEST": "1"}),
    (["all2all", "-from-fasta", "LIST", "OUT"], {}),
    (["all2all", "-from-fasta", "-mesh", "2", "LIST", "OUT"], {}),
    (["all2all", "DB", "OUT"], {"KMERDB_COORD": "localhost:1234"}),
    (["build", "-mesh", "2", "LIST", "OUT"], {}),
    (["build", "LIST", "OUT"], {"KMERDB_MESH": "auto"}),
    (["build", "LIST", "DB"], {"KMERDB_BUILD_DEVICE": "1"}),
    (["build", "LIST", "DB"], {"KMERDB_DEVICE_INGEST": "1"}),
    (["all2all", "DB", "OUT"], {"KMERDB_A2A_ENGINE": "bf16"}),
], ids=lambda v: " ".join(v) if isinstance(v, list) else
       ",".join(f"{k}={x}" for k, x in v.items()))
def test_unported_modes_are_refused(corpus, argv, env, monkeypatch, capsys):
    d, lst, _, port_db = corpus
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    subst = {"DB": port_db, "LIST": lst, "OUT": str(d / "refused.out")}
    assert port_main([subst.get(a, a) for a in argv]) == 255
    assert "not yet ported to kmerdb_tpu_torch" in capsys.readouterr().err
    assert not os.path.exists(subst["OUT"])


_NO_JAX_SCRIPT = """
import importlib, os, pkgutil, sys
sys.modules["jax"] = None   # any import of jax raises ImportError


def run(lst, out_dir):
    from kmerdb_tpu_torch.cli.main import main
    db = os.path.join(out_dir, "nojax.db")
    out = os.path.join(out_dir, "nojax.csv")
    assert main(["build", "-k", "18", lst, db]) == 0
    for var in ("KMERDB_A2A_DEVICE", "KMERDB_N2A_DEVICE", "KMERDB_D2D_DEVICE",
                "KMERDB_GRID_DEVICE"):
        os.environ[var] = "0"
    assert main(["all2all", db, out]) == 0
    samples = [s for s in open(lst).read().split() if s]
    assert main(["new2all", db, lst, out + ".n2a"]) == 0
    assert main(["one2all", db, samples[0] + ".fasta", out + ".o2a"]) == 0
    parts = os.path.join(out_dir, "nojax.parts")
    with open(parts, "w") as f:
        f.writelines([db + os.linesep] * 2)
    assert main(["all2all-parts", parts, out + ".parts"]) == 0
    # the host modes never pay torch's multi-second import
    assert "torch" not in sys.modules
    import kmerdb_tpu_torch
    for m in pkgutil.walk_packages(kmerdb_tpu_torch.__path__,
                                   "kmerdb_tpu_torch."):
        importlib.import_module(m.name)
    assert sys.modules["jax"] is None


if __name__ == "__main__":
    run(sys.argv[1], sys.argv[2])
"""


def test_port_runs_with_jax_blocked(corpus, monkeypatch):
    """Every port module imports, and build and the host tiers of
    all2all, new2all, one2all and all2all-parts run without importing
    torch, in a process where importing jax fails."""
    d, lst, jax_db, _ = corpus
    monkeypatch.setenv("KMERDB_A2A_DEVICE", "0")
    want = str(d / "want.csv")
    assert jax_main(["all2all", jax_db, want]) == 0
    script = d / "nojax.py"
    script.write_text(_NO_JAX_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, str(script), lst, str(d)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert (d / "nojax.csv").read_bytes() == pathlib.Path(want).read_bytes()
    for mode in ("n2a", "o2a", "parts"):
        assert (d / f"nojax.csv.{mode}").stat().st_size > 0
