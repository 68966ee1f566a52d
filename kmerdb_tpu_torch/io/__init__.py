"""Host-side input/output: FASTA, KMC and minhash readers, the database file."""
