// Bounded edit-distance infix search (edlib HW 'locations' parity).
//
// Replaces both kernels of the JAX package's ops/pallas_ed.py: _fwd_kernel
// (HW pass -> distance, first and last optimal end) and _rev_kernel
// (anchored SHW pass from the chosen end -> smallest optimal start). One
// launch computes (dist, start, end) for every row; the plain version is
// hw_locate_plain in nanoranger_torch/ops/edit_distance.py.
//
// What bounds it: per row the work is m dependent DP rows of W+1 cells
// (m = 18..54, W = 40..270 over the seven modes); the inputs are a few
// hundred bytes a row, so the card is bound by the dependent row chain, not
// by bytes. One warp owns one row: lane l holds columns CPL*l+1..CPL*l+CPL
// in registers, the diagonal neighbour comes from the lane to the left by
// one shuffle, and the horizontal moves (cost exactly 1) collapse to a
// prefix-min of t[j] - j, done within the lane and then by a 5-step warp
// scan. CPL is a template parameter chosen from the window width (4, 8, 12
// or 16 columns a lane: W <= 128, 256, 384, 512), so a narrow window pays
// for no column it does not have. The text row is staged in shared memory
// so the reverse pass reads it backwards from the chosen end without
// building reversed windows; rows without a hit skip the reverse pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;      // rows per block
constexpr int WLIMIT = 512;   // widest window: 16 columns per lane
constexpr int BIG = 1 << 20;
constexpr int N_CODE = 4;
constexpr int PAD_CODE = 5;

__device__ __forceinline__ int cost(int p, int tc, int wildcard) {
    bool eq = tc == p;
    if (wildcard) eq = eq || p == N_CODE || tc == N_CODE;
    return (eq && tc != PAD_CODE) ? 0 : 1;
}

// row[u] = D[i-1][j] on entry, D[i][j] on exit, j = CPL*lane + 1 + u;
// D[i-1][0] = i-1 and D[i][0] = i in both modes.
template <int CPL>
__device__ __forceinline__ void row_update(int (&row)[CPL],
                                           const int (&tc)[CPL], int p, int i,
                                           int wildcard, int lane) {
    int left = __shfl_up_sync(FULL, row[CPL - 1], 1);
    if (lane == 0) left = i - 1;
    int pre[CPL];
    int run = BIG;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
        const int diag = (u == 0 ? left : row[u - 1]) + cost(p, tc[u], wildcard);
        const int t = min(diag, row[u] + 1);
        run = min(run, t - (CPL * lane + 1 + u));
        pre[u] = run;
    }
    int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl = min(incl, v);
    }
    int carry = __shfl_up_sync(FULL, incl, 1);
    carry = lane == 0 ? i : min(i, carry);  // D[i][0] - 0 = i
#pragma unroll
    for (int u = 0; u < CPL; ++u)
        row[u] = min(carry, pre[u]) + (CPL * lane + 1 + u);
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

template <int CPL>
__global__ void hw_locate_kernel(const int8_t* __restrict__ pattern, int m,
                                 const int8_t* __restrict__ texts,
                                 const int* __restrict__ lengths, int R, int W,
                                 int k, int wildcard, int pick_last,
                                 int* __restrict__ dist_out,
                                 int* __restrict__ start_out,
                                 int* __restrict__ end_out) {
    constexpr int WMAX = 32 * CPL;
    __shared__ int8_t pat[64];
    __shared__ int8_t txt[WARPS][WMAX];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int x = threadIdx.x; x < m; x += blockDim.x) pat[x] = pattern[x];
    const int r = blockIdx.x * WARPS + warp;
    if (r < R) {
        for (int x = lane; x < WMAX; x += 32)
            txt[warp][x] = x < W ? texts[(size_t)r * W + x] : (int8_t)PAD_CODE;
    }
    __syncthreads();
    if (r >= R) return;  // whole warp
    const int len = lengths[r];

    int tc[CPL], row[CPL];
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
        tc[u] = txt[warp][CPL * lane + u];
        row[u] = 0;                               // HW: D[0][j] = 0
    }
    for (int i = 1; i <= m; ++i) row_update<CPL>(row, tc, pat[i - 1], i, wildcard, lane);

    int score[CPL];
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
        const int j = CPL * lane + 1 + u;
        score[u] = j <= len ? row[u] : BIG;
    }
    int lmin = BIG;
#pragma unroll
    for (int u = 0; u < CPL; ++u) lmin = min(lmin, score[u]);
    const int dist = warp_min(lmin);
    int first = BIG, last = -1;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
        if (score[u] == dist) {
            first = min(first, CPL * lane + u);   // inclusive end = j - 1
            last = max(last, CPL * lane + u);
        }
    }
    first = warp_min(first);
    last = warp_max(last);
    const bool hit = dist <= k;
    const int e = pick_last ? last : first;
    int start = -1;
    if (hit) {
        // anchored SHW over Tr[x] = T[e - x], x = 0..e, PAD beyond
#pragma unroll
        for (int u = 0; u < CPL; ++u) {
            const int x = CPL * lane + u;
            tc[u] = x <= e ? txt[warp][e - x] : PAD_CODE;
            row[u] = x + 1;                       // SHW: D[0][j] = j
        }
        for (int i = 1; i <= m; ++i)
            row_update<CPL>(row, tc, pat[m - i], i, wildcard, lane);
        int xm = -1;
#pragma unroll
        for (int u = 0; u < CPL; ++u) {
            const int x = CPL * lane + u;
            if (x <= e && row[u] == dist) xm = max(xm, x);
        }
        xm = warp_max(xm);
        start = e - xm;
    }
    if (lane == 0) {
        dist_out[r] = hit ? dist : -1;
        start_out[r] = hit ? start : -1;
        end_out[r] = hit ? e : -1;
    }
}

}  // namespace

extern "C" int hw_locate(const void* pattern, const void* texts,
                         const void* lengths, void* dist, void* start,
                         void* end, int m, int R, int W, int k, int wildcard,
                         int pick_last, void* stream) {
    if (R == 0) return 0;
    if (W < 1 || W > WLIMIT || m > 64 || m < 1)
        return (int)cudaErrorInvalidValue;
    const int blocks = (R + WARPS - 1) / WARPS;
#define NR_ED_LAUNCH(cpl)                                                    \
    hw_locate_kernel<cpl><<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(  \
        (const int8_t*)pattern, m, (const int8_t*)texts,                     \
        (const int*)lengths, R, W, k, wildcard, pick_last, (int*)dist,       \
        (int*)start, (int*)end)
    if (W <= 128) NR_ED_LAUNCH(4);
    else if (W <= 256) NR_ED_LAUNCH(8);
    else if (W <= 384) NR_ED_LAUNCH(12);
    else NR_ED_LAUNCH(16);
#undef NR_ED_LAUNCH
    return (int)cudaGetLastError();
}
