"""nanoranger-torch: the PyTorch/CUDA port of nanoranger-tpu.

A second package beside the JAX package (the reference, which it never
imports). Plain tensor code is PyTorch; every Pallas kernel of the JAX
package on the ported path is a CUDA C++ kernel written for Hopper
(csrc/, built by nvcc at first use, see kernels.py), and each has a plain
PyTorch version beside it that runs on CPU tensors.

Layout mirrors the JAX package:
  chemistry   — ChemistrySpec registry (a copy)
  io          — fastq/fasta/whitelist IO, base encoding (copies)
  align       — minimizer index + seed-chain aligner
  ops         — the kernels' wrappers with their plain versions, and the
                kernel-free DP ops
  stages      — decon, the fused per-batch step, barcode matching,
                dedup/counting, clone joins
  vdj         — native clonotyper (V alignment on the device, CDR3 calls,
                clone assembly and exports)
  runtime     — host C++ banded aligner (built by g++ at first use)
  parallel    — data x whitelist sharding over a mesh of devices
  tools       — multi-host fastq split and shard-output merge (copies)
  pipeline    — CLI entry point, all seven modes, sharded or not
  convert     — carry the JAX package's index/whitelist arrays over
"""

__version__ = "0.1.0"
