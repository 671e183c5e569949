"""K4's share of its roofline (csrc/verify.cu, the one-vs-all whitelist DP)
over the profiled sample's launches, in percent: the least time of its
launch shapes (roofline/kernels.k4) over the card's time of the kernel.
Moves reads_per_s."""

import readers


def read(run: dict) -> float | None:
    return readers.roofline_pct(run, "k4", "verify_kernel")
