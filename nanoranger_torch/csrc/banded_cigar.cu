// Banded global affine alignment with traceback -> CIGAR text, for a batch
// of (query segment, target segment) pairs: the genome stage's exon blocks
// (band 160) and the clonotyper's V spans (band 48).
//
// Replaces no TPU kernel: the JAX package runs this DP on the host, and so
// did the port until this kernel. It replaces the host routine
// runtime/native/banded_align.cpp (align_one), which stays as the CPU path
// and as the oracle, and gives bit for bit its scores, NM and CIGARs: the
// same scoring (+2, -4, gap open -4, extend -2, a base >= 4 never
// matches), band max(band, |lq - lt| + 16) about the centre i * lt / lq,
// the same tie-breaks, NEG guards and traceback order, and the same
// traceback byte layout ((lq + 1) rows of bw = 2 * band + 1 bytes, row 0
// and cells off the target all 0), so that the traceback reads what the
// host routine reads even on a path that touches the band's edge.
//
// What bounds it: a K562 genome-stage batch is ~520 segments, ~4.7e7 band
// cells, at ~20 integer operations a cell (~0.06 ms of the card's int32
// rate over 132 SMs) and one traceback byte a cell written (~0.014 ms of
// its 3.35 TB/s); but a segment's rows are a chain of lq dependent steps
// and its traceback a chain of lq + lt dependent loads, and one segment a
// warp gives the card a few warps an SM, so the launch is bound by those
// chains' latency, not by operations or bytes.
//
// Design: one warp a segment; lane l owns a contiguous slice of CPL = 11
// band cells of a row, so one pass holds band 160's 321 cells (a wider row
// is made in chunks of 352, carrying the cell left of each chunk). M and X
// read only the row before, which the warp keeps in device memory (three
// int rows of the segment's band, one slot a segment: every lane reads the
// cells it needs, the warp syncs, then writes the new row over it). Y, the
// in-row deletion chain y_b = max(open_b, y_{b-1} - 2), is a max-plus
// prefix scan: z_b = y_b + 2b is the running max of open_b + 2b, within
// the lane and then across lanes by five shuffles; each cell's Y bit is
// then read from the final y_{b-1}. Values that fail a NEG guard may sit
// anywhere at or below NEG / 2 before they are stored as NEG: the guards
// compare them only with NEG / 2. After the last row lane 0 walks the
// traceback and writes the run-length text backwards into the segment's
// slot of 2 * (lq + lt) bytes (a run of k ops takes at most k + 1
// characters, k >= 1); the wrapper slices it out by (start, length).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MATCH = 2, MISMATCH = -4, GAP_OPEN = -4, GAP_EXT = -2;
constexpr int NEG = -(1 << 28);
constexpr int HALF = NEG / 2;
constexpr unsigned FULL = 0xffffffffu;
// meta row of a segment: q_off, q_len, t_off, t_len, tb_off, text_off,
// row_off
constexpr int META = 7;
constexpr int CPL = 11;                      // band cells a lane

__device__ __forceinline__ int center(int i, int lq, int lt) {
    return lq ? (int)((long long)i * lt / lq) : 0;
}

// one run of the CIGAR, written backwards: the op, then its digits
__device__ __forceinline__ char* emit(char* p, int run, char op) {
    *--p = op;
    do {
        *--p = (char)('0' + run % 10);
        run /= 10;
    } while (run);
    return p;
}

__global__ void banded_cigar_kernel(
        const int8_t* __restrict__ seq, const long long* __restrict__ meta,
        uint8_t* __restrict__ tb_all, int* __restrict__ grows,
        char* __restrict__ text, int* __restrict__ out, int n, int band0) {
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int r = blockIdx.x * (blockDim.x >> 5) + w;
    if (r >= n) return;                      // the whole warp leaves
    const long long* md = meta + (size_t)r * META;
    const int8_t* q = seq + md[0];
    const int lq = (int)md[1];
    const int8_t* t = seq + md[2];
    const int lt = (int)md[3];
    uint8_t* tb = tb_all + md[4];
    char* slot_end = text + md[5] + 2 * ((long long)lq + lt);
    int* o = out + 4 * (size_t)r;
    if (lq == 0 && lt == 0) {
        if (lane == 0) {
            o[0] = 0; o[1] = 0; o[2] = (int)md[5]; o[3] = 0;
        }
        return;
    }
    const int band = max(band0, abs(lq - lt) + 16);
    const int bw = 2 * band + 1;
    int* rm = grows + md[6];
    int* rx = rm + bw;
    int* ry = rx + bw;

    // row 0: centre 0, so band column b is target column b - band
    for (int b = lane; b < bw; b += 32) {
        const int j = b - band;
        rm[b] = j == 0 ? 0 : NEG;
        rx[b] = NEG;
        ry[b] = (j > 0 && j <= lt) ? GAP_OPEN + GAP_EXT * j : NEG;
        tb[b] = 0;
    }
    __syncwarp();

    constexpr int W = 32 * CPL;
    int cp = 0, rem = 0;                     // centre(i - 1), its remainder
    for (int i = 1; i <= lq; ++i) {
        // centre(i) = floor(i * lt / lq), stepped from centre(i - 1)
        const int a = rem + lt;
        const int d = a / lq;
        const int ci = cp + d;
        rem = a - d * lq;
        const int shift = ci - cp;
        const int qc = q[i - 1];
        const int jb = ci - band;            // target column of band column 0
        uint8_t* tbrow = tb + (size_t)i * bw;
        // carries from the chunk before: its last cell of this row (m, x,
        // y, z) and its last lane's X source of the row before (the cell a
        // shift of 0 makes the next chunk's first diagonal source)
        int cm_l = NEG, cx_l = NEG, y_l = NEG, z_l = NEG;
        int dm = NEG, dx = NEG, dy = NEG;
        for (int c0 = 0; c0 < bw; c0 += W) {
            const int b0 = c0 + lane * CPL;
            const int rb = b0 + shift - 1;   // row-before column of p[0]
            int pm[CPL + 1], px[CPL + 1], py[CPL + 1];
#pragma unroll
            for (int u = 0; u <= CPL; ++u) {
                const int idx = rb + u;
                const bool in = idx >= 0 && idx < bw;
                pm[u] = in ? rm[idx] : NEG;
                px[u] = in ? rx[idx] : NEG;
                py[u] = in ? ry[idx] : NEG;
            }
            if (c0 > 0 && lane == 0 && shift == 0) {
                pm[0] = dm; px[0] = dx; py[0] = dy;
            }
            __syncwarp();                    // all reads before any write

            int cm[CPL], cx[CPL], code[CPL];
            bool ok[CPL];
#pragma unroll
            for (int u = 0; u < CPL; ++u) {
                const int b = b0 + u;
                const int j = jb + b;
                ok[u] = b < bw && j >= 0 && j <= lt;
                // diagonal from (i-1, j-1): a cell off the target there
                // holds NEG, so j == 0 needs no test of its own
                const int tc = (j >= 1 && j <= lt) ? t[j - 1] : 4;
                const int s = (qc == tc && qc < 4) ? MATCH : MISMATCH;
                int best = pm[u], src = 0;
                if (px[u] > best) { best = px[u]; src = 1; }
                if (py[u] > best) { best = py[u]; src = 2; }
                int m = NEG, cd = 0;
                if (best > HALF) { m = best + s; cd = src; }
                // X from (i-1, j)
                const int open = max(pm[u + 1], py[u + 1]) + GAP_OPEN + GAP_EXT;
                const int ext = px[u + 1] + GAP_EXT;
                int x = NEG;
                if (ext >= open && ext > HALF) { x = ext; cd |= 4; }
                else if (open > HALF) x = open;
                cm[u] = ok[u] ? m : NEG;
                cx[u] = ok[u] ? x : NEG;
                code[u] = ok[u] ? cd : 0;
            }

            // Y: opens from the cell to the left in this row, then the scan
            int lm = __shfl_up_sync(FULL, cm[CPL - 1], 1);
            int lx = __shfl_up_sync(FULL, cx[CPL - 1], 1);
            if (lane == 0) { lm = cm_l; lx = cx_l; }
            int yopen[CPL], loc[CPL];
            int run = lane == 0 ? z_l : NEG;
#pragma unroll
            for (int u = 0; u < CPL; ++u) {
                const int om = u ? cm[u - 1] : lm;
                const int ox = u ? cx[u - 1] : lx;
                yopen[u] = max(om, ox) + GAP_OPEN + GAP_EXT;
                run = max(run, ok[u] ? yopen[u] + 2 * (b0 + u) : NEG);
                loc[u] = run;
            }
            int inc = run;
#pragma unroll
            for (int k = 1; k < 32; k <<= 1) {
                const int v = __shfl_up_sync(FULL, inc, k);
                if (lane >= k) inc = max(inc, v);
            }
            int ex = __shfl_up_sync(FULL, inc, 1);
            if (lane == 0) ex = NEG;
            int y[CPL];
#pragma unroll
            for (int u = 0; u < CPL; ++u) {
                const int yy = max(ex, loc[u]) - 2 * (b0 + u);
                y[u] = (ok[u] && yy > HALF) ? yy : NEG;
            }
            int ly = __shfl_up_sync(FULL, y[CPL - 1], 1);
            if (lane == 0) ly = y_l;
#pragma unroll
            for (int u = 0; u < CPL; ++u) {
                const int ext = (u ? y[u - 1] : ly) + GAP_EXT;
                if (ok[u] && ext >= yopen[u] && ext > HALF) code[u] |= 8;
            }

#pragma unroll
            for (int u = 0; u < CPL; ++u) {
                const int b = b0 + u;
                if (b < bw) {
                    rm[b] = cm[u];
                    rx[b] = cx[u];
                    ry[b] = y[u];
                    tbrow[b] = (uint8_t)code[u];
                }
            }
            cm_l = __shfl_sync(FULL, cm[CPL - 1], 31);
            cx_l = __shfl_sync(FULL, cx[CPL - 1], 31);
            y_l = __shfl_sync(FULL, y[CPL - 1], 31);
            z_l = __shfl_sync(FULL, inc, 31);
            dm = __shfl_sync(FULL, pm[CPL], 31);
            dx = __shfl_sync(FULL, px[CPL], 31);
            dy = __shfl_sync(FULL, py[CPL], 31);
        }
        __syncwarp();                        // the row is whole
        cp = ci;
    }
    if (lane != 0) return;

    // terminal (lq, lt); the traceback as the host routine walks it
    const int bT = lt - center(lq, lq, lt) + band;
    if (bT < 0 || bT >= bw) {
        o[0] = NEG; o[1] = -1; o[2] = (int)md[5]; o[3] = 0;
        return;
    }
    const int tm = rm[bT], tx = rx[bT], ty = ry[bT];
    const int score = max(tm, max(tx, ty));
    int state = score == tm ? 0 : (score == tx ? 1 : 2);
    const long long tb_n = (long long)(lq + 1) * bw;
    int i = lq, j = lt, nm = 0, run = 0;
    char op_run = 0;
    char* p = slot_end;
    while (i > 0 || j > 0) {
        char op;
        if (i == 0) {
            op = 'D'; --j; ++nm;
        } else if (j == 0) {
            op = 'I'; --i; ++nm;
        } else {
            const long long idx =
                (long long)i * bw + (j - center(i, lq, lt) + band);
            const int code = (idx >= 0 && idx < tb_n) ? tb[idx] : 0;
            if (state == 0) {
                const int qb = q[i - 1];
                const bool eq = qb == t[j - 1] && qb < 4;
                op = eq ? '=' : 'X';
                nm += !eq;
                state = code & 3;
                --i; --j;
            } else if (state == 1) {
                op = 'I'; ++nm;
                state = (code & 4) ? 1 : 0;
                --i;
            } else {
                op = 'D'; ++nm;
                state = (code & 8) ? 2 : 0;
                --j;
            }
        }
        if (op == op_run) {
            ++run;
        } else {
            if (run) p = emit(p, run, op_run);
            op_run = op;
            run = 1;
        }
    }
    if (run) p = emit(p, run, op_run);
    o[0] = score;
    o[1] = nm;
    o[2] = (int)(p - text);
    o[3] = (int)(slot_end - p);
}

}  // namespace

// seq: the batch's query and target bases (int8); meta: (n, 7) int64;
// tb: the launch's traceback bytes; grows: the DP rows, 3 * bw int32 a
// segment; text: the CIGAR slots; out: (n, 4) int32 = score, NM, text
// start, text length.
extern "C" int banded_cigar(const void* seq, const void* meta, void* tb,
                            void* grows, void* text, void* out, int n,
                            int band, int warps, void* stream) {
    if (n == 0) return 0;
    if (warps < 1 || warps > 8) return (int)cudaErrorInvalidValue;
    const dim3 grid((n + warps - 1) / warps), block(32 * warps);
    banded_cigar_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int8_t*)seq, (const long long*)meta, (uint8_t*)tb,
        (int*)grows, (char*)text, (int*)out, n, band);
    return (int)cudaGetLastError();
}
