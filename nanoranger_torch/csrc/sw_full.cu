// End-to-end rescore of one candidate against one FULL padded whitelist
// row: STAR EndToEnd score plus the query index aligned to the UMI
// reference column, with no assumption about where the row's N pads lie.
//
// Replaces the JAX package's ops/pallas_sw.py::_sw_kernel; the plain
// version is sw_end2end_plain in nanoranger_torch/ops/sw.py. Scoring: match
// +1, mismatch -1, 0 if either base is N, -1 if either is PAD, linear gaps
// -1, query consumed end to end, reference flanks free. The forward pass
// fills F column by column (F[i][0] = -i, row 0 free), the backward pass
// fills B from the last column (B[i][Lr] = -(qlen - i), row qlen free);
// the column of F before reference column c and the column of B after it
// are kept, and the UMI position is the LARGEST query index qi < qlen with
// F[qi][c] + s(q[qi], r[c]) + B[qi+1][c+1] == score.
//
// What bounds it: a pair is ~100 bytes in and 12 out against 2 * Lr
// dependent column steps over Lq + 1 rows, so the card is bound by the
// dependent column chain and by launch latency, not by bytes. One warp owns
// one pair: lane l holds DP rows 4l..4l+3 (Lq + 1 <= 128 rows) of the
// current column in registers, the diagonal neighbour comes from the next
// lane by one shuffle, and the query-insertion chain (cost exactly 1 a row)
// collapses to a prefix-max of t[i] + i (suffix-max of t[i] - i backwards),
// done within the lane and then by a 5-step warp scan. Both snapshot
// columns stay in registers; the reference row is staged in shared memory.
//
// The integer scores live in float32 registers, where they are exact
// (|score| < 2^21): int32 forms of the verify.cu and sw_banded.cu DP loops
// were miscompiled by ptxas (CUDA 12.9, sm_90a), and float max/add issue at
// twice the int32 rate besides.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int RPL = 4;          // DP rows per lane
constexpr int ROWS = 32 * RPL;  // Lq + 1 <= ROWS
constexpr int LRMAX = 128;      // widest reference row
constexpr int WARPS = 4;        // pairs per block
constexpr float NEG = -1048576.f;
constexpr int N_CODE = 4;
constexpr int PAD_CODE = 5;

__device__ __forceinline__ float sub_score(int qc, int rc) {
    if (qc == PAD_CODE || rc == PAD_CODE) return -1.f;
    if (qc == N_CODE || rc == N_CODE) return 0.f;
    return qc == rc ? 1.f : -1.f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__global__ void sw_full_kernel(const int8_t* __restrict__ q,
                               const int* __restrict__ qlen,
                               const int8_t* __restrict__ refs,
                               const int* __restrict__ rlen, int P, int Lq,
                               int Lr, int c, int* __restrict__ score_out,
                               int* __restrict__ qpos_out,
                               int* __restrict__ valid_out) {
    __shared__ int8_t ref[WARPS][LRMAX];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int p = blockIdx.x * WARPS + warp;
    if (p >= P) return;  // whole warp; no block-wide barrier below
    for (int x = lane; x < Lr; x += 32) ref[warp][x] = refs[(size_t)p * Lr + x];
    __syncwarp();
    const int n = qlen[p];
    const int lr = min(rlen[p], Lr);     // live reference columns
    const int8_t* qp = q + (size_t)p * Lq;

    // row i = RPL*lane + u: qprev[u] = q[i-1] (forward), qcur[u] = q[i]
    int qprev[RPL], qcur[RPL];
    float fi[RPL];
#pragma unroll
    for (int u = 0; u < RPL; ++u) {
        const int i = RPL * lane + u;
        qprev[u] = (i >= 1 && i <= Lq) ? qp[i - 1] : PAD_CODE;
        qcur[u] = i < Lq ? qp[i] : PAD_CODE;
        fi[u] = (float)i;
    }

    // ---- forward: col = F[:, j] on entry, F[:, j+1] on exit
    float col[RPL], fc[RPL];
    float best = NEG;                    // this lane's share of max F[n][*]
#pragma unroll
    for (int u = 0; u < RPL; ++u) {
        const int i = RPL * lane + u;
        col[u] = i <= n ? -fi[u] : NEG;
        fc[u] = 0.f;
        if (i == n) best = col[u];
    }
    for (int j = 0; j < lr; ++j) {
        const int rj = ref[warp][j];
        if (j == c) {
#pragma unroll
            for (int u = 0; u < RPL; ++u) fc[u] = col[u];
        }
        float above = __shfl_up_sync(FULL, col[RPL - 1], 1);
        if (lane == 0) above = NEG;
        float pre[RPL];
        float run = NEG;
#pragma unroll
        for (int u = 0; u < RPL; ++u) {
            const int i = RPL * lane + u;
            const float diag = (u == 0 ? above : col[u - 1])
                + sub_score(qprev[u], rj);
            float t = fmaxf(diag, col[u] - 1.f);
            if (i == 0) t = 0.f;                      // row 0 free
            run = fmaxf(run, t + fi[u]);
            pre[u] = run;
        }
        float incl = run;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float v = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl = fmaxf(incl, v);
        }
        float carry = __shfl_up_sync(FULL, incl, 1);
        if (lane == 0) carry = NEG;
#pragma unroll
        for (int u = 0; u < RPL; ++u) {
            const int i = RPL * lane + u;
            col[u] = i <= n ? fmaxf(carry, pre[u]) - fi[u] : NEG;
            if (i == n) best = fmaxf(best, col[u]);
        }
    }
    best = warp_max(best);

    // ---- backward: col = B[:, j+1] on entry, B[:, j] on exit
    float bc[RPL];
#pragma unroll
    for (int u = 0; u < RPL; ++u) {
        const int i = RPL * lane + u;
        col[u] = i <= n ? -((float)n - fi[u]) : NEG;
        bc[u] = col[u];
    }
    for (int j = lr - 1; j >= 0; --j) {
        const int rj = ref[warp][j];
        if (j == c) {
#pragma unroll
            for (int u = 0; u < RPL; ++u) bc[u] = col[u];
        }
        const float below = __shfl_down_sync(FULL, col[0], 1);
        float suf[RPL];
        float run = NEG;
#pragma unroll
        for (int u = RPL - 1; u >= 0; --u) {
            const int i = RPL * lane + u;
            const float next = u == RPL - 1 ? below : col[u + 1];
            float t = fmaxf(next + sub_score(qcur[u], rj), col[u] - 1.f);
            if (i == n) t = 0.f;                      // row qlen free
            if (i > n) t = NEG;
            run = fmaxf(run, t - fi[u]);
            suf[u] = run;
        }
        float incl = run;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float v = __shfl_down_sync(FULL, incl, o);
            if (lane + o < 32) incl = fmaxf(incl, v);
        }
        float carry = __shfl_down_sync(FULL, incl, 1);
        if (lane == 31) carry = NEG;
#pragma unroll
        for (int u = 0; u < RPL; ++u) {
            const int i = RPL * lane + u;
            col[u] = i <= n ? fmaxf(carry, suf[u]) + fi[u] : NEG;
        }
    }

    // ---- diagonal edge (qi, c) -> (qi+1, c+1) on an optimal path
    const float below = __shfl_down_sync(FULL, bc[0], 1);
    int qpos = -1;
    if (c < lr) {
        const int rc = ref[warp][c];
#pragma unroll
        for (int u = 0; u < RPL; ++u) {
            const int qi = RPL * lane + u;
            const float b1 = u == RPL - 1 ? below : bc[u + 1];
            if (qi < n && fc[u] + sub_score(qcur[u], rc) + b1 == best)
                qpos = qi;
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        qpos = max(qpos, __shfl_xor_sync(FULL, qpos, o));
    if (lane == 0) {
        score_out[p] = (int)best;
        qpos_out[p] = qpos;
        valid_out[p] = qpos >= 0;
    }
}

}  // namespace

extern "C" int sw_full(const void* q, const void* qlen, const void* refs,
                       const void* rlen, void* score, void* qpos, void* valid,
                       int P, int Lq, int Lr, int c, void* stream) {
    if (P == 0) return 0;
    if (Lq < 1 || Lq + 1 > ROWS || Lr < 1 || Lr > LRMAX || c < 0 || c >= Lr)
        return (int)cudaErrorInvalidValue;
    const int blocks = (P + WARPS - 1) / WARPS;
    sw_full_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const int*)qlen, (const int8_t*)refs,
        (const int*)rlen, P, Lq, Lr, c, (int*)score, (int*)qpos, (int*)valid);
    return (int)cudaGetLastError();
}
