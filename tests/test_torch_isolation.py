"""kmerdb_tpu_torch stands alone: it imports nothing of kmerdb_tpu or JAX.

An AST scan finds no ``import``/``from`` of ``kmerdb_tpu``, ``kmerdb_tpu.*``
or ``jax`` in any module of the port or in ``chip_smoke.py``.  A
subprocess installs the import blocker that ``chip_smoke.py`` installs,
imports every module of the port, and runs the port's CLI on the host
tiers over a small corpus: ``build``, ``all2all`` (dense and ``-sparse
-min num-kmers:...``), ``all2all-sp``, ``new2all``, ``one2all``,
``all2all-parts``, ``distance`` and ``minhash``; then, over a mesh of two
CPU slots, ``all2all -mesh 2`` and ``all2all-sp -mesh 2``.  Each output
file is compared byte for byte with what kmerdb_tpu's CLI writes from the
same inputs.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from kmerdb_tpu.cli.main import main as jax_main
from kmerdb_tpu.parallel import runtime as jax_runtime
from kmerdb_tpu.utils import bench_corpus, native

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in
                    (REPO / "kmerdb_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py"]
REFUSED = ("kmerdb_tpu", "jax")


def _imported(tree) -> list:
    """Top-level package names of every absolute import in the tree."""
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return [n.split(".")[0] for n in names]


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_import_of_kmerdb_tpu_or_jax(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    assert not [n for n in _imported(tree) if n in REFUSED]


#: the blocker of chip_smoke.py, then the port's CLI on the host tiers
_SCRIPT = """
import importlib, os, pkgutil, sys

sys.path.insert(0, os.getcwd())
import chip_smoke
chip_smoke.refuse_jax_imports()


def run(lst, parts, mh_list, out):
    from kmerdb_tpu_torch.cli.main import main
    for var in ("KMERDB_A2A_DEVICE", "KMERDB_N2A_DEVICE", "KMERDB_D2D_DEVICE",
                "KMERDB_GRID_DEVICE"):
        os.environ[var] = "0"
    samples = [s for s in open(lst).read().split() if s]
    for argv in ARGV:
        argv = [a.format(out=out, lst=lst, parts=parts, mh=mh_list,
                         one=samples[3] + ".fasta") for a in argv]
        assert main(argv) == 0, argv
    # the host modes never pay torch's multi-second import
    assert "torch" not in sys.modules
    # a mesh of two CPU slots: the sharded routes on the plain kernels
    import torch
    from kmerdb_tpu_torch import _torchinit
    _torchinit.devices = lambda: [torch.device("cpu")] * 2
    for argv in MESH_ARGV:
        assert main([a.format(out=out) for a in argv]) == 0, argv
    import kmerdb_tpu_torch
    for m in pkgutil.walk_packages(kmerdb_tpu_torch.__path__,
                                   "kmerdb_tpu_torch."):
        importlib.import_module(m.name)
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "kmerdb_tpu")]


if __name__ == "__main__":
    run(*sys.argv[1:])
"""

#: every ported mode; {out} is the side's output directory
ARGV = [
    ["build", "-k", "18", "{lst}", "{out}/db"],
    ["build", "-k", "18", "{out}/half0.list", "{out}/part0.db"],
    ["build", "-k", "18", "{out}/half1.list", "{out}/part1.db"],
    ["all2all", "{out}/db", "{out}/a2a.csv"],
    ["all2all", "-sparse", "-min", "num-kmers:2500", "{out}/db",
     "{out}/a2a-sparse.csv"],
    ["all2all-sp", "-min", "num-kmers:2500", "{out}/db", "{out}/a2a-sp.csv"],
    ["new2all", "{out}/db", "{lst}", "{out}/n2a.csv"],
    ["one2all", "{out}/db", "{one}", "{out}/o2a.csv"],
    ["all2all-parts", "{out}/parts.list", "{out}/parts.csv"],
    ["distance", "mash", "{out}/a2a.csv", "{out}/a2a.mash"],
    ["minhash", "-f", "0.2", "{mh}"],
]
#: the mesh modes, run after the host modes
MESH_ARGV = [
    ["all2all", "-mesh", "2", "{out}/db", "{out}/a2a-mesh.csv"],
    ["all2all-sp", "-mesh", "2", "-min", "num-kmers:2500", "{out}/db",
     "{out}/a2a-sp-mesh.csv"],
]
OUTPUTS = ["db", "part0.db", "a2a.csv", "a2a-sparse.csv", "a2a-sp.csv",
           "n2a.csv", "o2a.csv", "parts.csv", "a2a.mash", "a2a-mesh.csv",
           "a2a-sp-mesh.csv"]


def _side(root: pathlib.Path, name: str, samples: list) -> tuple:
    """(output dir, its part-db list, its own copy of three genomes' list
    for minhash, which writes next to its inputs)."""
    out = root / name
    (out / "mh").mkdir(parents=True)
    half = len(samples) // 2
    for i, chunk in enumerate((samples[:half], samples[half:])):
        (out / f"half{i}.list").write_text("\n".join(chunk) + "\n")
    (out / "parts.list").write_text(f"{out}/part0.db\n{out}/part1.db\n")
    copies = []
    for s in samples[:3]:
        dst = out / "mh" / (pathlib.Path(s).name + ".fasta")
        shutil.copy(s + ".fasta", dst)
        copies.append(str(dst)[:-len(".fasta")])
    (out / "mh.list").write_text("\n".join(copies) + "\n")
    return out, out / "parts.list", out / "mh.list"


@pytest.fixture(scope="module")
def both_sides(tmp_path_factory):
    """Each package's outputs of ARGV on one corpus; the port's in a
    subprocess with kmerdb_tpu and jax refused."""
    if not native.available:
        pytest.skip("no native host runtime")
    root = tmp_path_factory.mktemp("isolation")
    lst = bench_corpus.generate(str(root / "corpus"), n_samples=12,
                                genome_len=4000)
    samples = [s for s in pathlib.Path(lst).read_text().split() if s]
    outs = {}
    for name in ("jax", "port"):
        out, parts, mh = _side(root, name, samples)
        outs[name] = out
        if name == "jax":
            for argv in ARGV + MESH_ARGV:
                argv = [a.format(out=out, lst=lst, parts=parts, mh=mh,
                                 one=samples[3] + ".fasta") for a in argv]
                assert jax_main(argv) == 0, argv
            jax_runtime.configure(None)
            continue
        script = root / "isolated.py"
        script.write_text(_SCRIPT.replace("MESH_ARGV", repr(MESH_ARGV))
                          .replace("ARGV", repr(ARGV)))
        env = dict(os.environ, PYTHONPATH=str(REPO))
        env.pop("JAX_PLATFORMS", None)
        r = subprocess.run([sys.executable, str(script), lst, str(parts),
                            str(mh), str(out)], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
    return outs


@pytest.mark.parametrize("name", OUTPUTS)
def test_port_output_matches_jax_with_jax_refused(both_sides, name):
    got = (both_sides["port"] / name).read_bytes()
    assert got and got == (both_sides["jax"] / name).read_bytes()


def test_minhash_files_match_jax_with_jax_refused(both_sides):
    names = sorted(p.name for p in (both_sides["jax"] / "mh").glob(
        "*.minhash"))
    assert len(names) == 3
    for n in names:
        assert (both_sides["port"] / "mh" / n).read_bytes() == \
            (both_sides["jax"] / "mh" / n).read_bytes()


def test_threads_option_reaches_the_ports_own_runtime(both_sides,
                                                      monkeypatch):
    """-t sets the thread count of the port's C++ runtime, not
    kmerdb_tpu's."""
    from kmerdb_tpu.utils import native as jax_native
    from kmerdb_tpu_torch.cli.main import main as port_main
    from kmerdb_tpu_torch.utils import native as port_native
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(port_native, "set_threads", calls["port"].append)
    monkeypatch.setattr(jax_native, "set_threads", calls["jax"].append)
    out = both_sides["port"] / "threads.mash"
    assert port_main(["distance", "-t", "3", "mash",
                      str(both_sides["port"] / "a2a.csv"), str(out)]) == 0
    assert out.read_bytes() == (both_sides["jax"] / "a2a.mash").read_bytes()
    assert calls == {"port": [3], "jax": []}
