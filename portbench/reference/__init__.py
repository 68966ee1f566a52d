"""The plain reference of the benchmark's comparison.

It works kmer-db's common-k-mer counts out from the genomes' FASTA files
with plain PyTorch and NumPy (reference/counts.py) and writes the CSV lines
kmer-db writes for them (reference/csvfmt.py).  It imports nothing of the
program under test, nor jax, nor kmerdb_tpu.
"""
