// Bounded edit-distance infix search (edlib HW 'locations' parity).
//
// Replaces both kernels of the JAX package's ops/pallas_ed.py: _fwd_kernel
// (HW pass -> distance, first and last optimal end) and _rev_kernel
// (anchored SHW pass from the chosen end -> smallest optimal start). One
// launch computes (dist, start, end) for every row; the plain version is
// hw_locate_plain in nanoranger_torch/ops/edit_distance.py.
//
// What bounds it: a row is m DP rows (m = 14..54) by len columns (len <=
// W = 40..270 over the seven modes) and a few hundred bytes, so the card
// is bound by the chain of dependent column steps of the longest walk,
// not by bytes. The design is the bit-parallel recurrence of Myers (1999)
// in Hyyrö's form, which edlib implements: the vertical deltas of a whole
// DP column live in two words Pv / Mv of m bits (one 32-bit word for
// m <= 32, a 64-bit pair for m <= 64), and one column is ~15 word
// operations with a dependent chain of ~6. The match masks Peq of the
// pattern and of the reversed pattern (one word per int8 code, so every
// code the plain version accepts scores as it does) are built once a block
// in shared memory, from __match_any_sync over the pattern's bases.
//
// A block of 64 threads takes RB <= 64 neighbouring rows (fewer when the
// launch has few rows, so that every SM gets blocks), stages their text,
// contiguous in memory, into shared memory by 16-byte asynchronous copies,
// and cuts the columns of its non-empty rows into at most 64 chunks of C
// columns, one a thread: most sub-windows of the windowed modes are empty,
// and a long row would otherwise set its warp's walk. A chunk of columns
// [a, b) walks the forward HW pass (top row D[0][j] = 0: the carry into
// bit 0 is 0) from a fresh top row m + k columns early, at s = max(0,
// a - m - k). That never gives a value below the true D[m][j], and gives
// the true one wherever it is <= k: an alignment of cost <= k ending at
// j >= a spans at most m + k text bases, so it starts at or after s. So
// the row's minimum over its chunks, with its first (or last) column, is
// exact wherever the row hits, and a row above k reports -1 either way:
// each step folds (D[m][j], j) into one packed key by one min, and a
// shared-memory atomicMin merges a row's chunks. The reverse SHW pass (top row
// D[0][x] = x: carry 1) then runs once for each hitting row over T[e - x],
// x = 0..min(e, m + dist - 1) only: an alignment of the m pattern bases to
// x + 1 text bases costs at least x + 1 - m, so no later x can reach dist.
// The start is e minus the largest x with D[m][x + 1] == dist. Each walk
// loads the match masks of its next PREFETCH columns while it steps
// through the current ones.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 64;      // threads per block, and most rows a block
constexpr int WLIMIT = 512;   // widest window
constexpr int BIG = 1 << 20;
constexpr int N_CODE = 4;
constexpr int PAD_CODE = 5;
constexpr int CODES = 256;    // every int8 code
constexpr int PREFETCH = 4;   // columns a group
// a row's (dist, column) packed into one int: dist <= 64, j < 512
constexpr int JBITS = 9;
constexpr int JMASK = (1 << JBITS) - 1;

// One DP column: Pv / Mv hold the vertical deltas (+1 / -1) of D[1..m][j]
// on entry and of column j + 1 on exit; hin is the top row's horizontal
// delta (0: HW, 1: SHW). Returns D[m][j+1] - D[m][j].
template <typename Word>
__device__ __forceinline__ int column(Word& Pv, Word& Mv, Word eq, Word hin,
                                      int hi) {
    const Word xv = eq | Mv;
    const Word xh = (((eq & Pv) + Pv) ^ Pv) | eq;
    Word ph = Mv | ~(xh | Pv);
    Word mh = Pv & xh;
    const int d = (int)((ph >> hi) & 1) - (int)((mh >> hi) & 1);
    ph = (ph << 1) | hin;
    mh <<= 1;
    Pv = mh | ~(xv | ph);
    Mv = ph & xv;
    return d;
}

// LAST: report the last optimal end (else the first)
template <typename Word, bool LAST>
__global__ void __launch_bounds__(ROWS)
hw_locate_kernel(const int8_t* __restrict__ pattern, int m,
                 const int8_t* __restrict__ texts,
                 const int* __restrict__ lengths, int R, int W, int RB,
                 int k, int wildcard, int* __restrict__ dist_out,
                 int* __restrict__ start_out, int* __restrict__ end_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    Word* peq = (Word*)smem;                  // [2][CODES]: pattern, reversed
    Word* eqb = peq + 2 * CODES;              // [2][CODES]: exact matches only
    __shared__ int ns[ROWS], keys[ROWS], units[ROWS], wsum[2][3];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int r0 = blockIdx.x * RB;
    const int rows = min(RB, R - r0);

    // stage the block's rows, rows * W contiguous bytes, by 16-byte
    // asynchronous copies that stay in flight while the tables are built;
    // the buffer starts as far past a 16-byte boundary as the source does
    const int nbytes = rows * W;
    const int8_t* src = texts + (size_t)r0 * W;
    const int mis = (int)((uintptr_t)src & 15);
    int8_t* txt = (int8_t*)(eqb + 2 * CODES) + mis;
    const int head = min(nbytes, (16 - mis) & 15);
    const int n16 = (nbytes - head) >> 4;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(txt + head);
    for (int x = tid; x < n16; x += ROWS)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(dst + 16 * x), "l"(src + head + 16 * x));
    asm volatile("cp.async.commit_group;\n" ::);
    for (int x = tid; x < head; x += ROWS) txt[x] = src[x];
    for (int x = head + 16 * n16 + tid; x < nbytes; x += ROWS)
        txt[x] = src[x];

    // warp 0 takes the pattern, warp 1 the reversed pattern, 32 bases a go
    int pc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int i = 32 * h + lane;
        pc[h] = i < m ? (uint8_t)pattern[warp ? m - 1 - i : i] : 0;
    }
    const int n = tid < rows ? min(max(lengths[r0 + tid], 0), W) : 0;
    ns[tid] = n;
    keys[tid] = 0x7fffffff;
    const int s_n = __reduce_add_sync(FULL, n);
    const int s_rows = __popc(__ballot_sync(FULL, n > 0));
    if (lane == 0) {
        wsum[warp][0] = s_n;
        wsum[warp][1] = s_rows;
    }
    for (int c = tid; c < 2 * CODES; c += ROWS) eqb[c] = 0;
    __syncthreads();

    // exact matches: bit i of entry c is set where base i (of the order
    // this warp takes) is c
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const bool ok = 32 * h + lane < m;
        const unsigned act = __ballot_sync(FULL, ok);
        if (ok)
            ((unsigned*)&eqb[warp * CODES + pc[h]])[h] =
                __match_any_sync(act, pc[h]);
    }
    // chunks: C columns each, so that the non-empty rows' chunks fit the
    // block's threads (one chunk a row where every row is non-empty)
    const int tot = wsum[0][0] + wsum[1][0];
    const int busy = wsum[0][1] + wsum[1][1];
    const int C = busy < ROWS ? max(1, (tot + ROWS - busy - 1) / (ROWS - busy))
                              : W;
    const int cnt = n > 0 ? (n + C - 1) / C : 0;
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
    }
    if (lane == 31) wsum[warp][2] = incl;
    __syncthreads();

    const int off = incl - cnt + (warp ? wsum[0][2] : 0);
    for (int c = 0; c < cnt; ++c) units[off + c] = (tid << 16) | c;
    const int U = wsum[0][2] + wsum[1][2];
    const Word n_fwd = eqb[N_CODE];
    const Word n_rev = eqb[CODES + N_CODE];
    for (int c = tid; c < CODES; c += ROWS) {
        Word f = eqb[c], b = eqb[CODES + c];
        if (wildcard) {            // pattern N matches every code, text N
            f |= n_fwd;            // every base
            b |= n_rev;
            if ((int8_t)c == N_CODE) f = b = ~(Word)0;
        }
        if ((int8_t)c == PAD_CODE) f = b = 0;      // PAD matches nothing
        peq[c] = f;
        peq[CODES + c] = b;
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();

    const int hi = m - 1;
    // forward HW pass over this thread's chunk [a, b) of row `row`, from s
    int row = 0, a = 0, b = 0, s = 0;
    if (tid < U) {
        const int u = units[tid];
        row = u >> 16;
        a = (u & 0xffff) * C;
        b = min(ns[row], a + C);
        s = max(0, a - m - min(max(k, 0), W));
    }
    const int8_t* rt = txt + row * W;
    const int nr = ns[row];
    // the column a key carries: j, or 511 - j to find the last end first
    constexpr int flip = LAST ? JMASK : 0;
    Word Pv = ~(Word)0, Mv = 0;
    int score = m, key = 0x7fffffff;
    const int len_warp = __reduce_max_sync(FULL, b - s);
    Word eq[PREFETCH];
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u)
        eq[u] = peq[(uint8_t)rt[min(s + u, W - 1)]];
    for (int t = 0; t < len_warp; t += PREFETCH) {
        Word nxt[PREFETCH];
#pragma unroll
        for (int u = 0; u < PREFETCH; ++u)
            nxt[u] = peq[(uint8_t)rt[min(s + t + PREFETCH + u, W - 1)]];
#pragma unroll
        for (int u = 0; u < PREFETCH; ++u) {
            score += column<Word>(Pv, Mv, eq[u], 0, hi);
            // any column of the row counts, not only [a, b): a restarted
            // value is never below the true one, and equal to it where it
            // is the row's minimum <= k
            const int j = s + t + u;
            if (j < nr) key = min(key, (score << JBITS) | (j ^ flip));
            eq[u] = nxt[u];
        }
    }
    if (tid < U) atomicMin(&keys[row], key);
    __syncthreads();

    // reverse SHW pass for this thread's row, x = 0..min(e, m + dist - 1)
    const int dist = keys[tid] >> JBITS;
    const bool hit = n > 0 && dist <= k;
    const int e = hit ? (keys[tid] & JMASK) ^ flip : 0;
    const int xe = hit ? min(e, m + dist - 1) : -1;
    const int xe_warp = __reduce_max_sync(FULL, xe);
    const int8_t* rr = txt + min(tid, rows - 1) * W;
    const Word* prev = peq + CODES;
    Pv = ~(Word)0;
    Mv = 0;
    score = m;
    int xm = 0;
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u)
        eq[u] = prev[(uint8_t)rr[max(e - u, 0)]];
    for (int x = 0; x <= xe_warp; x += PREFETCH) {
        Word nxt[PREFETCH];
#pragma unroll
        for (int u = 0; u < PREFETCH; ++u)
            nxt[u] = prev[(uint8_t)rr[max(e - x - PREFETCH - u, 0)]];
#pragma unroll
        for (int u = 0; u < PREFETCH; ++u) {
            score += column<Word>(Pv, Mv, eq[u], 1, hi);
            xm = (x + u <= xe && score == dist) ? x + u : xm;
            eq[u] = nxt[u];
        }
    }
    if (tid < rows) {
        dist_out[r0 + tid] = hit ? dist : -1;
        start_out[r0 + tid] = hit ? e - xm : -1;
        end_out[r0 + tid] = hit ? e : -1;
    }
}

int sm_count() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev) != cudaSuccess)
            sms = 132;
    }
    return sms;
}

}  // namespace

extern "C" int hw_locate(const void* pattern, const void* texts,
                         const void* lengths, void* dist, void* start,
                         void* end, int m, int R, int W, int k, int wildcard,
                         int pick_last, void* stream) {
    if (R == 0) return 0;
    if (W < 1 || W > WLIMIT || m > 64 || m < 1)
        return (int)cudaErrorInvalidValue;
    // rows a block: 64, or fewer so that the launch has two blocks an SM
    const int RB = max(1, min(ROWS, R / (2 * sm_count())));
    const int blocks = (R + RB - 1) / RB;
#define NR_ED_LAUNCH(word, last)                                             \
    hw_locate_kernel<word, last><<<blocks, ROWS,                             \
                                   4 * CODES * sizeof(word) + 16 + RB * W,   \
                                   (cudaStream_t)stream>>>(                  \
        (const int8_t*)pattern, m, (const int8_t*)texts,                     \
        (const int*)lengths, R, W, RB, k, wildcard, (int*)dist, (int*)start, \
        (int*)end)
    if (m <= 32 && pick_last) NR_ED_LAUNCH(uint32_t, true);
    else if (m <= 32) NR_ED_LAUNCH(uint32_t, false);
    else if (pick_last) NR_ED_LAUNCH(uint64_t, true);
    else NR_ED_LAUNCH(uint64_t, false);
#undef NR_ED_LAUNCH
    return (int)cudaGetLastError();
}
