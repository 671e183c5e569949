"""K1's share of its roofline (csrc/chain.cu, map-ont and splice classes)
over the profiled sample's launches, in percent: the least time of its
launch shapes (roofline/kernels.k1) over the card's time of the kernels.
Moves reads_per_s."""

import readers


def read(run: dict) -> float | None:
    return readers.roofline_pct(run, "k1", "chain_dp_kernel")
