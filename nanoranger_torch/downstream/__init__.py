"""Downstream analytics over the CB/UB/XT-tagged BAM — htslib-free ports of
the reference's scripts/downstream/* and scripts/store_nanopore_stats.py.

Copies of the JAX package's downstream/ modules, reading the BAM through
this package's io/bam.py."""
