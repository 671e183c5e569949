// End-to-end rescore of one candidate against one FULL reference row:
// STAR EndToEnd score plus the query index aligned to the UMI reference
// column c, with no assumption about where the row's N pads lie.
//
// Replaces the JAX package's ops/pallas_sw.py::_sw_kernel; the plain
// version is sw_end2end_plain in nanoranger_torch/ops/sw.py. Scoring: match
// +1, mismatch -1, 0 if either base is N, -1 if either is PAD, linear gaps
// -1, query consumed end to end, reference flanks free. F[i][j] is the best
// alignment of q[0..i) ending before reference column j (F[i][0] = -i, row
// 0 free); B[i][j] the best of q[i..qlen) starting at column j (B[i][lr] =
// -(qlen - i), row qlen free), over the pair's lr live columns.
//
// The split. Every end-to-end path crosses the column boundary
// k = min(c + 1, lr), or ends at or before it, or starts at or after it, so
//
//     score = max( max_{j <= k} F[qlen][j],        paths that end by k
//                  max_{j >= k} B[0][j],           paths that start from k
//                  max_i F[i][k] + B[i][k] )       paths that cross k
//
// exactly, with each term a max over a subset of the paths and the three
// subsets covering all of them. The forward half fills F over columns
// 0..k-1 and the backward half B over columns lr-1..k: each column is
// walked once, and the two halves run side by side, so a pair's serial
// chain is max(k, lr - k) column steps, not the 2 * lr of two full passes.
// The UMI position needs nothing more: when c < lr, k = c + 1, F[:, c] is
// the forward half's column before its last step and B[:, c + 1] = B[:, k],
// and the position is the LARGEST query index qi < qlen with
// F[qi][c] + s(q[qi], r[c]) + B[qi+1][c+1] == score. With c >= lr there is
// no UMI column: qpos -1, valid false.
//
// What bounds it: a pair is ~100 bytes in and 9 out against its chain of
// max(k, lr - k) dependent column steps over qlen + 1 rows, so the card is
// bound by that chain and by launch latency, not by bytes or operations.
// One pair a block of two warps: warp 0 runs the forward half, warp 1 the
// backward half, and hands B[:, k] and its row-0 maximum to warp 0 through
// shared memory (129 floats) behind one barrier; warp 0 forms the score,
// finds the UMI row by four ballots and writes score, qpos and the
// validity as a byte (a torch.bool tensor). In each warp lane l holds DP
// rows 4l..4l+3 (qlen + 1 <= 128 rows) of the current column in
// registers; the insertion chain (cost exactly 1 a row) collapses to a
// prefix max of t[i] + i forwards (a suffix max of t[i] - i backwards),
// done within the lane and then by a 5-step warp scan. The neighbour row
// of the next column's diagonal is the next lane's end row, which is its
// inclusive scan value, our carry, less (plus) its row index, so a column
// step takes six shuffles. The substitution scores use selects only, and
// the reference row is staged once in shared memory and read one column
// ahead of the step that needs it.
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

// F[:, j] -> F[:, j+1] through reference code rj. `above` is F[4l-1][j]
// on entry and F[4l-1][j+1] on exit; `best` takes F[n][j+1] in the lane
// holding row n.
__device__ __forceinline__ void fwd_step(float (&col)[RPL], float& above,
                                         float& best, const int (&qprev)[RPL],
                                         const float (&fi)[RPL], int rj,
                                         int lane, int n, bool above_ok,
                                         float fabove) {
    float pre[RPL];
    float run = NEG;
#pragma unroll
    for (int u = 0; u < RPL; ++u) {
        const float diag = (u == 0 ? above : col[u - 1])
            + sub_score(qprev[u], rj);
        float t = fmaxf(diag, col[u] - 1.f);
        if (u == 0 && lane == 0) t = 0.f;                 // row 0 free
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
    above = above_ok ? carry - fabove : NEG;
}

// B[:, j+1] -> B[:, j] through reference code rj. `below` is B[4l+4][j+1]
// on entry and B[4l+4][j] on exit.
__device__ __forceinline__ void bwd_step(float (&col)[RPL], float& below,
                                         const int (&qcur)[RPL],
                                         const float (&fi)[RPL], int rj,
                                         int lane, int n, bool below_ok,
                                         float fbelow) {
    float suf[RPL];
    float run = NEG;
#pragma unroll
    for (int u = RPL - 1; u >= 0; --u) {
        const int i = RPL * lane + u;
        const float next = u == RPL - 1 ? below : col[u + 1];
        float t = fmaxf(next + sub_score(qcur[u], rj), col[u] - 1.f);
        if (i == n) t = 0.f;                              // row qlen free
        run = fmaxf(run, t - fi[u]);
        suf[u] = run;
    }
    // a lane at or above 32 - o gets its own value back
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
        incl = fmaxf(incl, __shfl_down_sync(FULL, incl, o));
    float carry = __shfl_down_sync(FULL, incl, 1);
    if (lane == 31) carry = NEG;
#pragma unroll
    for (int u = 0; u < RPL; ++u) {
        const int i = RPL * lane + u;
        col[u] = i <= n ? fmaxf(carry, suf[u]) + fi[u] : NEG;
    }
    below = below_ok ? carry + fbelow : NEG;
}

__global__ void __launch_bounds__(64)
sw_full_kernel(const int8_t* __restrict__ q, const int* __restrict__ qlen,
               const int8_t* __restrict__ refs, const int* __restrict__ rlen,
               int Lq, int Lr, int c, int* __restrict__ score_out,
               int* __restrict__ qpos_out, uint8_t* __restrict__ valid_out) {
    __shared__ int8_t ref[LRMAX];
    __shared__ float bk[ROWS + 1];     // B[4l+u][k] at u*32 + l; max B[0][k..]
    const int p = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int x = threadIdx.x; x < Lr; x += 64)
        ref[x] = refs[(size_t)p * Lr + x];
    __syncthreads();
    const int n = qlen[p];
    const int lr = max(0, min(rlen[p], Lr));    // live reference columns
    const int k = min(c + 1, lr);               // the split column
    const int8_t* qp = q + (size_t)p * Lq;

    float fi[RPL], col[RPL];
#pragma unroll
    for (int u = 0; u < RPL; ++u) fi[u] = (float)(RPL * lane + u);

    // forward state kept past the barrier
    int qprev[RPL];
    float best = NEG, fc[RPL], fcab = NEG;

    if (warp == 1) {
        // ---- backward half: col = B[:, lr] on entry, B[:, k] on exit
        int qcur[RPL];
#pragma unroll
        for (int u = 0; u < RPL; ++u) {
            const int i = RPL * lane + u;
            qcur[u] = i < Lq ? qp[i] : PAD_CODE;
            col[u] = i <= n ? fi[u] - (float)n : NEG;
        }
        float brow0 = col[0];                   // lane 0: max B[0][j..lr]
        const bool below_ok = lane < 31 && RPL * lane + RPL <= n;
        const float fbelow = (float)(RPL * lane + RPL);
        float below = __shfl_down_sync(FULL, col[0], 1);
        if (lane == 31) below = NEG;
        int rj = ref[max(lr - 1, 0)];
        for (int j = lr - 1; j >= k; --j) {
            const int rn = ref[max(j - 1, 0)];
            bwd_step(col, below, qcur, fi, rj, lane, n, below_ok, fbelow);
            brow0 = fmaxf(brow0, col[0]);
            rj = rn;
        }
#pragma unroll
        for (int u = 0; u < RPL; ++u) bk[u * 32 + lane] = col[u];
        if (lane == 0) bk[ROWS] = brow0;
    } else {
        // ---- forward half: col = F[:, 0] on entry, F[:, k] on exit
#pragma unroll
        for (int u = 0; u < RPL; ++u) {
            const int i = RPL * lane + u;
            qprev[u] = (i >= 1 && i <= Lq) ? qp[i - 1] : PAD_CODE;
            col[u] = i <= n ? -fi[u] : NEG;
            if (i == n) best = col[u];
        }
        const bool above_ok = lane > 0 && RPL * lane - 1 <= n;
        const float fabove = (float)(RPL * lane - 1);
        float above = __shfl_up_sync(FULL, col[RPL - 1], 1);
        if (lane == 0) above = NEG;
        int rj = ref[0];
        for (int j = 0; j + 1 < k; ++j) {
            const int rn = ref[j + 1];
            fwd_step(col, above, best, qprev, fi, rj, lane, n, above_ok,
                     fabove);
            rj = rn;
        }
        // col = F[:, k-1], which is F[:, c] when c < lr
#pragma unroll
        for (int u = 0; u < RPL; ++u) fc[u] = col[u];
        fcab = above;
        if (k > 0)
            fwd_step(col, above, best, qprev, fi, rj, lane, n, above_ok,
                     fabove);
    }
    __syncthreads();
    if (warp == 1) return;

    // the crossing term, then the two side terms
#pragma unroll
    for (int u = 0; u < RPL; ++u) {
        if (RPL * lane + u <= n) best = fmaxf(best, col[u] + bk[u * 32 + lane]);
    }
    best = fmaxf(warp_max(best), bk[ROWS]);

    // the largest qi = i - 1 with F[i-1][c] + s(q[i-1], r[c]) + B[i][c+1]
    // == best, i = 1..n
    int qpos = -1;
    if (c < lr) {
        const int rc = ref[c];
#pragma unroll
        for (int u = 0; u < RPL; ++u) {
            const int i = RPL * lane + u;
            const float f = (u == 0 ? fcab : fc[u - 1])
                + sub_score(qprev[u], rc) + bk[u * 32 + lane];
            const unsigned ok = __ballot_sync(FULL, i >= 1 && i <= n
                                                        && f == best);
            if (ok) qpos = max(qpos, RPL * (31 - __clz(ok)) + u - 1);
        }
    }
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
    sw_full_kernel<<<P, 64, 0, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const int*)qlen, (const int8_t*)refs,
        (const int*)rlen, Lq, Lr, c, (int*)score, (int*)qpos,
        (uint8_t*)valid);
    return (int)cudaGetLastError();
}
