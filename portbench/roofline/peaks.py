"""The published ceilings of one NVIDIA H100 SXM5 (80 GB HBM3), each stated
once with where it comes from. They hold at the card's full power limit of
700 W; a card set lower runs slower under load, so every share is printed
beside the card's `power.limit`.

- HBM_BYTES_PER_S: 3.35 TB/s, NVIDIA H100 data sheet (SXM5, HBM3).
- LANE_INSTR_PER_S: 32-bit instructions a second, one a lane a clock on the
  128 FP32 lanes of each of the 132 SMs at the 1.98 GHz maximum boost
  (NVIDIA H100 data sheet and Hopper architecture whitepaper): 33.45e12.
  The data sheet's 67 TFLOP/s of float32 is the same rate counting a fused
  multiply-add as two operations, so it is not a ceiling for instructions
  that do one operation. The integer pipe alone issues half as many
  (64 results a clock on each SM for 32-bit add, compare, min and max:
  CUDA C Programming Guide, arithmetic instruction throughput, compute
  capability 9.0), and NVIDIA publishes no rate for the DPX instructions
  (`__vimax3_s16x2`, `__viaddmax_s16x2`) that K4 issues; the wider lane
  rate is taken for both kernels, so no share can pass 100% whichever
  pipe an instruction runs on.
"""

SMS = 132
BOOST_HZ = 1.98e9
FP32_LANES_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12
LANE_INSTR_PER_S = SMS * FP32_LANES_PER_SM * BOOST_HZ
