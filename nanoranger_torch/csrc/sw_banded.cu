// Banded end-to-end rescore of one candidate against its winning
// whitelist row: STAR EndToEnd score plus the query index aligned to the
// UMI reference column.
//
// Replaces the JAX package's ops/pallas_sw.py::_sw_banded_kernel; the
// plain version is sw_banded_plain in nanoranger_torch/ops/sw.py. The padded
// row is N*c_lo + core + N*(Lr - c): N columns score 0, so only the band
// columns c_lo..c need DP. The entry column is F[i][c_lo] = -max(0,
// i - c_lo), the completion through the N suffix from (i, c) is
// -max(0, (qlen - i) - (Lr - c)), and B[i][c+1] = -max(0, (qlen - i) -
// (Lr - c - 1)). The UMI position is the LARGEST query index qi with
// F[qi][c] + s(q[qi], r[c]) + B[qi+1][c+1] == score.
//
// What bounds it: a pair is ~100 bytes in and 12 out against nb - 1 = 16
// or 32 dependent band-column steps over qlen + 1 <= 97 rows, and a launch
// holds 59-256 pairs, so the card is bound by each pair's chain of column
// steps and by launch latency, not by bytes or operations. One warp owns
// one pair and fills F column by column in one pass, as the plain version
// does: lane l holds DP rows 4l..4l+3 (Lq + 1 <= 128 rows) in registers,
// and the query-insertion chain (cost exactly 1 a row) collapses to a
// prefix max of t[i] + i, done within the lane and then by a 5-step warp
// scan. After
// the last band column F[:, c] is in hand, so the completion and the UMI
// test are one compare a row: four ballots pick the largest passing row.
// The diagonal neighbour of row 4l in the next column is the lane below's
// last row, which is its inclusive scan value less its row index: the
// carry the lane already holds, so a column step takes six shuffles. One
// warp a block, so every SM gets a pair before any SM gets two; the
// validity is written as bytes, a torch.bool tensor.
//
// The integer scores live in float32 registers, where they are exact
// (|score| < 2^21): an int32 form of the row-wise loop this kernel had
// before, built by CUDA 12.9 for sm_90a, gave wrong scores whenever ptxas
// optimised it (-O1 and up).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int RPL = 4;          // DP rows per lane
constexpr int ROWS = 32 * RPL;  // Lq + 1 <= ROWS
constexpr int NB_MAX = 64;      // band columns held in two registers a lane
constexpr float NEG = -1048576.f;
constexpr int N_CODE = 4;
constexpr int PAD_CODE = 5;

// selects only: written with early returns or ||, it became a branch a row
__device__ __forceinline__ float sub_score(int qc, int rc) {
    const float s = qc == rc ? 1.f : -1.f;
    const float sn = ((qc == N_CODE) | (rc == N_CODE)) ? 0.f : s;
    return ((qc == PAD_CODE) | (rc == PAD_CODE)) ? -1.f : sn;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// NB band columns, or nb_rt of them when NB is 0
template <int NB>
__global__ void __launch_bounds__(32)
sw_banded_kernel(const int8_t* __restrict__ q, const int* __restrict__ qlen,
                 const int8_t* __restrict__ bands, int Lq, int nb_rt, int Lr,
                 int c_lo, int c, int* __restrict__ score_out,
                 int* __restrict__ qpos_out, uint8_t* __restrict__ valid_out) {
    const int p = blockIdx.x;
    const int lane = threadIdx.x;
    const int nb = NB ? NB : nb_rt;
    const int cb = nb - 1;
    // band column jp sits in lane jp % 32 of b[jp / 32]
    const int8_t* bp = bands + (size_t)p * nb;
    const int b0 = lane < nb ? bp[lane] : PAD_CODE;
    const int b1 = lane + 32 < nb ? bp[lane + 32] : PAD_CODE;
    const int8_t* qp = q + (size_t)p * Lq;
    const int n = qlen[p];
    const float fn = (float)n;
    const float flo = (float)c_lo;
    const float tail = (float)(Lr - c);      // N columns after column c

    // row i = RPL*lane + u holds q[i-1]; row 0 and rows past Lq hold PAD
    int qprev[RPL];
    float fi[RPL], col[RPL];
    float best = NEG;                        // this lane's share of F[n][*]
#pragma unroll
    for (int u = 0; u < RPL; ++u) {
        const int i = RPL * lane + u;
        qprev[u] = (i >= 1 && i <= Lq) ? qp[i - 1] : PAD_CODE;
        fi[u] = (float)i;
        col[u] = i <= n ? fminf(flo - fi[u], 0.f) : NEG;   // F[i][c_lo]
        if (i == n) best = col[u];
    }

    // above = F[RPL*lane - 1][j], the lane below's last row (NEG in lane 0)
    const float fabove = (float)(RPL * lane - 1);
    const bool above_ok = lane > 0 && RPL * lane - 1 <= n;
    float above = __shfl_up_sync(FULL, col[RPL - 1], 1);
    if (lane == 0) above = NEG;

    // band columns c_lo+1..c: col = F[:, c_lo + jp] on entry
#pragma unroll
    for (int jp = 0; jp < cb; ++jp) {
        const int rj = __shfl_sync(FULL, jp < 32 ? b0 : b1, jp & 31);
        float pre[RPL];
        float run = NEG;
#pragma unroll
        for (int u = 0; u < RPL; ++u) {
            const float diag = (u == 0 ? above : col[u - 1])
                + sub_score(qprev[u], rj);
            float t = fmaxf(diag, col[u] - 1.f);
            if (u == 0 && lane == 0) t = 0.f;             // row 0 free
            run = fmaxf(run, t + fi[u]);
            pre[u] = run;
        }
        // a lane below o gets its own value back, which max leaves as is
        float incl = run;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1)
            incl = fmaxf(incl, __shfl_up_sync(FULL, incl, o));
        float carry = __shfl_up_sync(FULL, incl, 1);
        if (lane == 0) carry = NEG;
#pragma unroll
        for (int u = 0; u < RPL; ++u) {
            const int i = RPL * lane + u;
            col[u] = i <= n ? fmaxf(carry, pre[u]) - fi[u] : NEG;
            if (i == n) best = fmaxf(best, col[u]);
        }
        // the lane below's last row is its inclusive max, our carry, less
        // its row index: the next column's diagonal needs no shuffle
        above = above_ok ? carry - fabove : NEG;
    }

    // col = F[:, c]: the completion through the N suffix, then the score
#pragma unroll
    for (int u = 0; u < RPL; ++u) {
        if (RPL * lane + u <= n)
            best = fmaxf(best, col[u] - fmaxf((fn - fi[u]) - tail, 0.f));
    }
    best = warp_max(best);

    // the largest qi = i - 1 with F[i-1][c] + s(q[i-1], r[c]) + B[i][c+1]
    // == best, i = 1..n
    const int rc = __shfl_sync(FULL, cb < 32 ? b0 : b1, cb & 31);
    int qpos = -1;
#pragma unroll
    for (int u = 0; u < RPL; ++u) {
        const int i = RPL * lane + u;
        const float f = (u == 0 ? above : col[u - 1]) + sub_score(qprev[u], rc)
            - fmaxf((fn - fi[u]) - (tail - 1.f), 0.f);
        const unsigned ok = __ballot_sync(FULL, i >= 1 && i <= n && f == best);
        if (ok) qpos = max(qpos, RPL * (31 - __clz(ok)) + u - 1);
    }
    if (lane == 0) {
        score_out[p] = (int)best;
        qpos_out[p] = qpos;
        valid_out[p] = qpos >= 0;
    }
}

}  // namespace

extern "C" int sw_banded(const void* q, const void* qlen, const void* band,
                         void* score, void* qpos, void* valid, int P, int Lq,
                         int NB, int Lr, int c_lo, int c, void* stream) {
    if (P == 0) return 0;
    if (Lq < 1 || Lq + 1 > ROWS || NB < 1 || NB > NB_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
#define NR_SW_LAUNCH(nb)                                                     \
    sw_banded_kernel<nb><<<P, 32, 0, s>>>(                                   \
        (const int8_t*)q, (const int*)qlen, (const int8_t*)band, Lq, NB, Lr, \
        c_lo, c, (int*)score, (int*)qpos, (uint8_t*)valid)
    if (NB == 17) NR_SW_LAUNCH(17);
    else if (NB == 33) NR_SW_LAUNCH(33);
    else NR_SW_LAUNCH(0);
#undef NR_SW_LAUNCH
    return (int)cudaGetLastError();
}
