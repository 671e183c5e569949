// K4: exhaustive one-vs-all whitelist DP, each candidate against every core.
//
// Replaces the JAX package's TPU kernel ops/whitelist_verify.py::
// _verify_kernel (:163, launched at :312). The plain version is verify_all_plain in
// nanoranger_torch/ops/whitelist_verify.py, and this kernel equals it bit
// for bit. For candidate q (length n = qlen) and whitelist core row r (m
// chars between N pads of pad_left / pad_right), the STAR-equivalent
// end-to-end score over the padded row has closed forms in the N columns:
//
//   H_t[0] = -max(0, t - pad_left)              (prefix-N entry)
//   H_0[j] = 0                                  (free ref start)
//   H_t[j] = max(H_{t-1}[j-1] + s(q_t, core_j),  H_{t-1}[j] - 1,
//                H_t[j-1] - 1)
//   score  = max(max_j H_n[j], H_n[0],
//                max_t H_t[m] - max(0, (n - t) - pad_right))
//
// where s is -1 if either char is PAD, else 0 if either is N, else +1 on a
// match and -1 on a mismatch (that order). Each block writes, per
// candidate, (best score, smallest best row, number of rows at that score)
// over its rows; rows at or past r_valid never win. The wrapper merges the
// per-block partials with torch ops.
//
// What bounds it: operations. At the main-path shape (512 candidates of
// ~60 bases against 737,280 cores of 16) it is ~2.7e11 DP cells against
// ~12 MB of input, and every cell is a max-plus update that depends on the
// cell before it. The card issues one warp instruction a clock on each of
// an SM's four schedulers, and its min/max pipe (DPX included) takes one
// every other clock, so the time follows the instructions a cell and their
// pipes. What this design does about it:
//
// * Offsets turn both gap terms into plain maxima. With
//   K_t[j] = H_t[j] + j + t the recurrence becomes
//       K_t[j] = max(K_{t-1}[j-1] + s'(q_t, core_j), K_{t-1}[j], K_t[j-1])
//   with s' = s + 2 in {1, 2, 3} and K_t[0] = min(t, pad_left). A cell is
//   one 32-bit add and one three-way DPX maximum (__vimax3_s16x2), and the
//   add goes to the FMA pipe (IMAD.IADD).
// * Two whitelist rows a thread: rows 2i and 2i + 1 sit in the low and high
//   16-bit lanes of every register, so each instruction advances two cells.
//   int16 cannot overflow: with Lq <= 128, m <= 32 and both pads clamped to
//   [0, 128], H_t[j] lies in [-(t + j), t], so 0 <= K <= 2 Lq + m = 288 and
//   diag + s' <= 291, and every runout and end term lies in [-288, 288].
//   As every K is >= 0, the 32-bit add never carries between the lanes.
// * The substitution profile is built once a block, not once a cell: four
//   packed tables in registers, prof[b][j] = s'(base b, core_j) of both
//   rows (4 m registers), so a step on a base reads its column scores with
//   no instruction at all. A query N (s' = 2, or 1 on a PAD core, from a
//   PAD bitmask of the two rows), a query PAD (s' = 1 everywhere) and any
//   other code (s' = 2 on an N core, else 1: the AND of the four profiles)
//   take the other arms of a switch on the query char that is uniform
//   across the block: PAD before N before equality, as in the plain
//   version, for any int8 query code against cores of codes 0..5. The block
//   stages one word a query step in shared memory, the char and the runout
//   of the suffix-N end, so a step costs one shared load beyond its
//   columns. (A byte-table profile read by one PRMT a column, and two state
//   arrays in turn, measured slower on the card.)
// * The grid is row blocks x candidate groups (blockIdx.y). GROUP = 16
//   candidates a block keeps the card full at every whitelist size: 17,753
//   rows give 70 row blocks, so 512 candidates make 70 x 32 = 2,240 blocks
//   and 336 make 1,470 (at least 4 x 132 SMs either way), and 737,280 rows x
//   118 candidates make 2,880 x 8 = 23,040. The profile build and the
//   staging are < 1% of a block's DP at 16 candidates.
// * One barrier for the whole reduction: each warp writes (best, smallest
//   index, ties) of every candidate of the group into shared memory, and
//   after one __syncthreads each warp reduces a candidate at a time with the
//   redux instructions. The NEG sentinel, the scores, the indices and the
//   tie counts are 32-bit there; within a thread the low lane (row 2i) is
//   taken before the high lane (row 2i + 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NEG = -(1 << 20);      // the JAX package's NEG
constexpr int BIG = 1 << 30;
constexpr int N_CODE = 4;
constexpr int PAD_CODE = 5;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 2 * THREADS;    // whitelist rows a block
constexpr int GROUP = 16;            // candidates a block
constexpr int LQ_MAX = 128;
constexpr unsigned ONES = 0x00010001u;     // 1 in both 16-bit lanes
constexpr unsigned INT16_MIN2 = 0x80008000u;

__device__ __forceinline__ unsigned pack2(int v) {
    return (unsigned)(v & 0xffff) * 0x10001u;
}

// a candidate's length as the DP runs it: a negative one scores as 0 does,
// as in the plain version, and none runs past the Lq staged steps
__device__ __forceinline__ int clamp_len(int n, int Lq) {
    return min(max(n, 0), Lq);
}

// s' = s + 2 of query base b against core char a
__device__ __forceinline__ unsigned sub2(int b, int a) {
    return a == b ? 3u : a == N_CODE ? 2u : 1u;
}

// one query step over the m packed columns of K, in place; diag and left
// enter as K_{t-1}[0] and K_t[0], and sub(j) is the packed s' of column
// j + 1. Every value is >= 0, so the 32-bit add of diag and s' never
// carries from one lane into the other.
template <int M, class Sub>
__device__ __forceinline__ void dp_cols(unsigned (&K)[M], unsigned diag,
                                        unsigned left, const Sub& sub) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
        const unsigned old = K[j];
        K[j] = __vimax3_s16x2(diag + sub(j), old, left);
        left = K[j];
        diag = old;
    }
}

// packed scores of one candidate, n steps of words w, against the
// thread's two rows: prof[b][j] is the packed s' of query base b against
// column j + 1, pad_lo / pad_hi the PAD bits of the two cores
template <int M>
__device__ __forceinline__ unsigned score_pair(
        const uint2* w, int n, const unsigned (&prof)[4][M],
        unsigned pad_lo, unsigned pad_hi, int pad_left, int pad_right) {
    unsigned K[M];
#pragma unroll
    for (int j = 0; j < M; ++j) K[j] = pack2(j + 1);   // H_0 = 0
    const unsigned pl = pack2(pad_left);
    unsigned k0 = 0u;                  // K_t[0] = min(t, pad_left)
    unsigned best_b = pack2(min(pad_right - n, 0));     // t = 0
    for (int t = 0; t < n; ++t) {
        const uint2 word = w[t];
        const unsigned diag = k0;
        k0 = __viaddmin_s16x2(k0, ONES, pl);
        // the query char is uniform across the block, and so are the
        // branches: bit tests on a base, since nvcc makes a switch here a
        // jump table, a constant load and an indirect branch every step
        const int c = (int)word.x;
        const auto base = [&](const unsigned (&p)[M]) {
            dp_cols<M>(K, diag, k0, [&](int j) { return p[j]; });
        };
        if ((unsigned)c < 4u) {
            if (c & 2) {
                if (c & 1) base(prof[3]);
                else base(prof[2]);
            } else {
                if (c & 1) base(prof[1]);
                else base(prof[0]);
            }
        } else if (c == N_CODE) {           // 0, but -1 against a PAD core
            dp_cols<M>(K, diag, k0, [&](int j) {
                return 2u * ONES - (((pad_lo >> j) & 1u)
                                    | (((pad_hi >> j) & 1u) << 16));
            });
        } else if (c == PAD_CODE) {         // -1 everywhere
            dp_cols<M>(K, diag, k0, [](int) { return ONES; });
        } else {
            // a code that equals no core char: 0 against an N core, where
            // all four profiles hold 2, and -1 elsewhere, where one holds 1
            dp_cols<M>(K, diag, k0, [&](int j) {
                return prof[0][j] & prof[1][j] & prof[2][j] & prof[3][j];
            });
        }
        best_b = __viaddmax_s16x2(K[M - 1], word.y, best_b);
    }
    unsigned best_a = INT16_MIN2;      // max_j H_n[j] + n
#pragma unroll
    for (int j = 0; j < M; ++j)
        best_a = __viaddmax_s16x2(K[j], pack2(-(j + 1)), best_a);
    best_a = __viaddmax_s16x2(best_a, pack2(-n),
                              pack2(min(pad_left - n, 0)));   // H_n[0]
    return __viaddmax_s16x2(best_a, 0u, best_b);
}

template <int M>
__global__ void __launch_bounds__(THREADS)
verify_kernel(const int8_t* __restrict__ q, const int* __restrict__ qlen,
              const int8_t* __restrict__ coreT, int C, int c_base, int Lq,
              int R, int r_valid, int pad_left, int pad_right,
              int* __restrict__ best_out, int* __restrict__ idx_out,
              int* __restrict__ ties_out) {
    __shared__ uint2 words[GROUP][LQ_MAX];
    __shared__ int qls[GROUP];
    __shared__ int wb[GROUP][WARPS], wi[GROUP][WARPS], wt[GROUP][WARPS];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int r = blockIdx.x * ROWS + 2 * threadIdx.x;     // rows r, r + 1
    const int c0 = c_base + blockIdx.y * GROUP;
    const int nc = min(GROUP, C - c0);
    // step t's word: query char t + 1 as it is, and the runout of the
    // suffix-N end in K's offset, min(0, pad_right - (n - t - 1)) - m -
    // (t + 1)
    for (int x = threadIdx.x; x < nc * Lq; x += THREADS) {
        const int cc = x / Lq, t = x % Lq;
        words[cc][t] = make_uint2(
            (unsigned)q[(size_t)c0 * Lq + x],
            pack2(min(pad_right - clamp_len(qlen[c0 + cc], Lq) + t + 1, 0)
                  - M - t - 1));
    }
    if (threadIdx.x < nc)
        qls[threadIdx.x] = clamp_len(qlen[c0 + threadIdx.x], Lq);

    // the substitution profile of rows r and r + 1 (PAD past R)
    const bool pairs = R % 2 == 0 && (uintptr_t)coreT % 2 == 0;
    unsigned prof[4][M], pad_lo = 0u, pad_hi = 0u;
#pragma unroll
    for (int j = 0; j < M; ++j) {
        const int8_t* col = coreT + (size_t)j * R;
        int a = PAD_CODE, b = PAD_CODE;
        if (pairs) {
            if (r < R) {
                const char2 v = *reinterpret_cast<const char2*>(col + r);
                a = v.x;
                b = v.y;
            }
        } else {
            if (r < R) a = col[r];
            if (r + 1 < R) b = col[r + 1];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
            prof[k][j] = sub2(k, a) | sub2(k, b) << 16;
        pad_lo |= (unsigned)(a == PAD_CODE) << j;
        pad_hi |= (unsigned)(b == PAD_CODE) << j;
    }
    const bool live_lo = r < R && r < r_valid;
    const bool live_hi = r + 1 < R && r + 1 < r_valid;
    __syncthreads();

    for (int cc = 0; cc < nc; ++cc) {
        const unsigned s = score_pair<M>(words[cc], qls[cc], prof, pad_lo,
                                         pad_hi, pad_left, pad_right);
        // a row at or past r_valid scores NEG and one past R does not
        // exist: with no live row, every row of the list ties at NEG, as in
        // the plain version
        const int s_lo = live_lo ? (int)(short)(s & 0xffffu)
                                 : r < R ? NEG : NEG - 1;
        const int s_hi = live_hi ? (int)s >> 16 : r + 1 < R ? NEG : NEG - 1;
        const int wbest = __reduce_max_sync(FULL, max(s_lo, s_hi));
        const int ix = wbest == NEG ? BIG
                       : s_lo == wbest ? r : s_hi == wbest ? r + 1 : BIG;
        const int nt = (s_lo == wbest) + (s_hi == wbest);
        const int widx = __reduce_min_sync(FULL, ix);
        const int wties = __reduce_add_sync(FULL, nt);
        if (lane == 0) {
            wb[cc][warp] = wbest;
            wi[cc][warp] = widx;
            wt[cc][warp] = wties;
        }
    }
    __syncthreads();
    // ties count only at the block's best: a warp's ties join where its
    // best is the block's
    for (int cc = warp; cc < nc; cc += WARPS) {
        const bool have = lane < WARPS;
        const int bb = have ? wb[cc][lane] : NEG;
        const int gb = __reduce_max_sync(FULL, bb);
        const bool sel = have && bb == gb;
        const int ii = __reduce_min_sync(FULL, sel ? wi[cc][lane] : BIG);
        const int tt = __reduce_add_sync(FULL, sel ? wt[cc][lane] : 0);
        if (lane == 0) {
            const size_t out = (size_t)blockIdx.x * C + c0 + cc;
            best_out[out] = gb;
            idx_out[out] = ii;
            ties_out[out] = tt;
        }
    }
}

}  // namespace

extern "C" int verify_all(const void* q, const void* qlen, const void* coreT,
                          void* best, void* idx, void* ties, int C, int Lq,
                          int m, int R, int r_valid, int pad_left,
                          int pad_right, void* stream) {
    // q holds any int8 codes, coreT codes 0..5 (as the whitelist tables make
    // them); a qlen is clamped to [0, Lq], where a negative one scores as 0
    // does and the plain version cannot index past Lq
    if (C == 0 || R == 0) return 0;
    if (Lq > LQ_MAX || pad_left < 0 || pad_right < 0)
        return (int)cudaErrorInvalidValue;
    if (m != 16 && m != 32) return (int)cudaErrorInvalidValue;
    // with n <= 128, a pad past 128 scores as 128 does
    pad_left = pad_left < LQ_MAX ? pad_left : LQ_MAX;
    pad_right = pad_right < LQ_MAX ? pad_right : LQ_MAX;
    cudaStream_t s = (cudaStream_t)stream;
    const int row_blocks = (R + ROWS - 1) / ROWS;
    constexpr int SLICE = 65535 * GROUP;     // gridDim.y is at most 65535
    for (int c_base = 0; c_base < C; c_base += SLICE) {
        const int nc = C - c_base < SLICE ? C - c_base : SLICE;
        const dim3 grid(row_blocks, (nc + GROUP - 1) / GROUP);
#define NR_VERIFY_LAUNCH(mm)                                                  \
        verify_kernel<mm><<<grid, THREADS, 0, s>>>(                           \
            (const int8_t*)q, (const int*)qlen, (const int8_t*)coreT, C,      \
            c_base, Lq, R, r_valid, pad_left, pad_right, (int*)best,          \
            (int*)idx, (int*)ties)
        if (m == 16) NR_VERIFY_LAUNCH(16);
        else NR_VERIFY_LAUNCH(32);
#undef NR_VERIFY_LAUNCH
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
