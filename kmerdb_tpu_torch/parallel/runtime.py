"""The CLI's mesh request: one per process (counterpart of
kmerdb_tpu/parallel/runtime.py).

``-mesh <n|auto>`` (or the KMERDB_MESH environment variable) makes every
console route its counting through parallel/sharded.py: the same command,
the same bytes, N devices.  The request is only recorded here; torch is
not imported until a console asks for the mesh.
"""

import os

_request: str | None = None
_mesh = None
_resolved = False


def configure(request: str | None) -> None:
    """Record the CLI's -mesh value ("auto", "4", ...); None leaves it to
    KMERDB_MESH.  Forgets a mesh resolved earlier (the CLI calls this once
    per invocation; tests call it to change the mesh in one process)."""
    global _request, _mesh, _resolved
    _request = request
    _mesh = None
    _resolved = False


def active_mesh():
    """The requested Mesh, or None for the single-card tiers.

    configure()'s value comes before KMERDB_MESH.  "", "0" and "1", and a
    request that resolves to one device, mean no mesh; "auto" takes every
    card.  The first call builds the mesh, later calls return it."""
    global _mesh, _resolved
    if _resolved:
        return _mesh
    req = _request if _request is not None \
        else os.environ.get("KMERDB_MESH", "")
    if req in ("", "0", "1"):
        _resolved = True
        return None
    from . import mesh as mesh_mod
    m = mesh_mod.make_mesh(None if req == "auto" else int(req))
    if m.size <= 1:
        m = None
    _mesh, _resolved = m, True
    return _mesh
