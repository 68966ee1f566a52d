"""kmerdb_tpu_torch: the kmer-db engine of kmerdb_tpu on PyTorch and CUDA.

A port of kmerdb_tpu (JAX and Pallas on a TPU) to one NVIDIA Hopper card.
It answers the same CLI, ``python -m kmerdb_tpu_torch <mode> ...``, and
writes the same bytes.  Host code (database, file formats, the C++ host
runtime, CSV writers) is shared with kmerdb_tpu through ``host.py``; the
device tier of ``all2all`` runs hand-written CUDA kernels
(``csrc/``, bound in ``ops/gram.py``).  Modes not ported yet are refused
by ``cli/main.py``.

This package imports torch and never jax.
"""
