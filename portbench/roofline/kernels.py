"""Operations and bytes of the two kernels whose roofline share the
benchmark reports, from the shapes of each launch (copied from the
arithmetic of chip_smoke.py's kernel table, with the peaks of peaks.py).

The least time of a launch is the larger of its bytes over the HBM rate
and its instructions over the lane rate. Each input byte is counted as
read once and each output byte as written once.
"""

from __future__ import annotations

from . import peaks


def k1(shape: tuple, n_valid: int, splice: bool) -> tuple:
    """K1 (csrc/chain.cu) on (B, A) anchors with n_valid valid slots:
    bytes = the valid flag of every slot, t, q and seg of the valid slots
    (nothing else changes an output), f, parent and root of every slot
    written; instructions = 64 window slots a valid anchor, 16 each (28
    with the splice class's intron arm)."""
    B, A = shape
    n_bytes = B * A * (1 + 4 * 3) + n_valid * 4 * 3
    n_instr = n_valid * 64 * (28 if splice else 16)
    return n_bytes, n_instr


def k4(q_shape: tuple, qlen_sum: int, core_shape: tuple) -> tuple:
    """K4 (csrc/verify.cu): C candidate rows of Lq against R whitelist
    cores of m: bytes = the cores, the candidates and three int32 outputs
    a candidate per block of 256 rows; instructions = one a DP cell (a
    packed 16x2 add of the diagonal's score and a packed three-way maximum
    serve two cells) over qlen cells of each core column of each row."""
    C, Lq = q_shape
    m, R = core_shape
    n_bytes = m * R + C * Lq + 3 * 4 * C * -(-R // 256)
    n_instr = qlen_sum * m * R
    return n_bytes, n_instr


def least_seconds(n_bytes: float, n_instr: float) -> float:
    return max(n_bytes / peaks.HBM_BYTES_PER_S,
               n_instr / peaks.LANE_INSTR_PER_S)
