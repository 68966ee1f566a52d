"""kmerdb_tpu_torch: the kmer-db engine of kmerdb_tpu on PyTorch and CUDA.

A port of kmerdb_tpu (JAX and Pallas on a TPU) to one NVIDIA Hopper card.
It answers the same CLI, ``python -m kmerdb_tpu_torch <mode> ...``, and
writes the same bytes.  It keeps its own copy of kmerdb_tpu's host code
(database, file formats, the C++ host runtime's bindings, the builder, CSV
writers, filters, the CLI) under the same module names; its device tiers
run hand-written CUDA kernels (``csrc/``, bound in ``ops/gram.py``).
Modes not ported yet are refused by ``cli/main.py``.

This package imports torch and never jax, and nothing of kmerdb_tpu.
"""

__version__ = "0.3.0"
