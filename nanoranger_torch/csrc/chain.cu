// Windowed colinear chain DP over (seg, t, q)-sorted anchors.
//
// Replaces the JAX package's ops/pallas_chain.py::_chain_kernel. Same
// recurrence as the plain version in nanoranger_torch/ops/chain.py:
// each anchor looks back over the G = 64 previous anchors of its read, only
// predecessors of the same seg count, the gap costs
// 0.01*k*dd + 0.5*log2(dd) in float32, the parent is the LAST argmax of the
// window and the chain root rides along, so no pointer chase is needed.
//
// Two gap classes, chosen at compile time (template <bool SPLICE>): the
// map-ont class above, and with SPLICE the minimap2 `-x splice` intron
// class beside it: a target gap beyond the band (bandwidth < dt-dq <=
// max_intron) with a small query gap costs
// 0.01*k*dq + splice_pen + 0.5*log2(dt-dq), and the map-ont class wins
// where both admit a predecessor. The map-ont instantiation carries no
// trace of the intron arm, so its code and times stay those of a
// one-class kernel.
//
// What bounds it: the anchor axis is a dependent chain (anchor i needs f of
// the 64 before it), so the work per read is sequential and the card is
// bound by latency, not by bytes (25 bytes in and out an anchor slot, ~210 MB
// at 2048 x 4096) nor by operations. The design keeps that chain short: one warp per read walks
// its anchors in order, the 64-slot predecessor ring lives in registers
// (two slots per lane), best and the last argmax are two warp-shuffle
// maxima, and the parent's root is one shuffle from the lane that holds
// it. Anchors are read 32 at a time (one coalesced load per lane) and
// broadcast by shuffle; outputs are written 32 at a time the same way.
// Invalid anchors skip the window work. 2048 reads give 2048 warps.
//
// Float parity: built with -fmad=false, and the sums use __fadd_rn /
// __fmul_rn in the order of the plain version, with log2f, so the card's
// plain torch version and this kernel give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEGF = -1e18f;
constexpr int SENT_SEG = -7;

__device__ __forceinline__ float warp_max_f(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

template <bool SPLICE>
__device__ __forceinline__ float candidate(float ti, float qi, int si,
                                           float tw, float qw, int sw,
                                           float fw, float k_span,
                                           float gap_coef, float max_gap,
                                           float bandwidth, float max_intron,
                                           float splice_pen) {
    float dt = __fsub_rn(ti, tw);
    float dq = __fsub_rn(qi, qw);
    float dd = fabsf(__fsub_rn(dq, dt));
    float dg = fminf(fminf(dq, dt), k_span);
    float gap = 0.f;
    if (dd > 0.f)
        gap = __fadd_rn(__fmul_rn(gap_coef, dd),
                        __fmul_rn(0.5f, log2f(fmaxf(dd, 1.f))));
    if constexpr (!SPLICE) {
        bool ok = (sw == si) && (fw > NEGF / 2) && (dt > 0.f) &&
                  (dq > 0.f) && (dt <= max_gap) && (dq <= max_gap) &&
                  (dd <= bandwidth);
        return ok ? __fsub_rn(__fadd_rn(fw, dg), gap) : NEGF;
    } else {
        const bool seg_eq = (sw == si) && (fw > NEGF / 2);
        const bool ok_n = seg_eq && (dt > 0.f) && (dq > 0.f) &&
                          (dt <= max_gap) && (dq <= max_gap) &&
                          (dd <= bandwidth);
        const float ds = __fsub_rn(dt, dq);
        const bool ok_s = seg_eq && (dq > 0.f) && (dq <= max_gap) &&
                          (ds > bandwidth) && (dt <= max_intron);
        if (!ok_n && ok_s)  // (0.01*k*dq + pen) + 0.5*log2(max(dt-dq, 1))
            gap = __fadd_rn(__fadd_rn(__fmul_rn(gap_coef, dq), splice_pen),
                            __fmul_rn(0.5f, log2f(fmaxf(ds, 1.f))));
        return (ok_n || ok_s) ? __fsub_rn(__fadd_rn(fw, dg), gap) : NEGF;
    }
}

template <bool SPLICE>
__global__ void chain_dp_kernel(const int* __restrict__ t,
                                const int* __restrict__ q,
                                const int* __restrict__ seg,
                                const uint8_t* __restrict__ valid,
                                float* __restrict__ f_out,
                                int* __restrict__ par_out,
                                int* __restrict__ root_out, int B, int A,
                                float k_span, float gap_coef, float max_gap,
                                float bandwidth, float max_intron,
                                float splice_pen) {
    const int read = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (read >= B) return;  // the whole warp leaves together
    const size_t row = (size_t)read * A;

    // ring slot s = lane + 32*h holds the latest anchor j < i, j = s mod 64
    float rt0 = 0.f, rt1 = 0.f, rq0 = 0.f, rq1 = 0.f;
    float rf0 = NEGF, rf1 = NEGF;
    int rs0 = SENT_SEG, rs1 = SENT_SEG, rr0 = -1, rr1 = -1;

    for (int base = 0; base < A; base += 32) {
        const int a = base + lane;
        int ct = 0, cq = 0, cs = SENT_SEG, cv = 0;
        if (a < A) {
            ct = t[row + a];
            cq = q[row + a];
            cs = seg[row + a];
            cv = valid[row + a];
        }
        float of = NEGF;
        int op = -1, orr = -1;
        const int n = min(32, A - base);
        for (int k = 0; k < n; ++k) {
            const int i = base + k;
            const float ti = (float)__shfl_sync(FULL, ct, k);
            const float qi = (float)__shfl_sync(FULL, cq, k);
            const int si = __shfl_sync(FULL, cs, k);
            const int vi = __shfl_sync(FULL, cv, k);
            float fi = NEGF;
            int pi = -1, rooti = -1;
            if (vi) {
                const int j0 = i - 64 + ((lane - i) & 63);
                const int j1 = i - 64 + ((lane + 32 - i) & 63);
                const float c0 = candidate<SPLICE>(
                    ti, qi, si, rt0, rq0, rs0, rf0, k_span, gap_coef,
                    max_gap, bandwidth, max_intron, splice_pen);
                const float c1 = candidate<SPLICE>(
                    ti, qi, si, rt1, rq1, rs1, rf1, k_span, gap_coef,
                    max_gap, bandwidth, max_intron, splice_pen);
                const float best = warp_max_f(fmaxf(c0, c1));
                const int key = max(c0 == best ? j0 : -1, c1 == best ? j1 : -1);
                const int bestj = warp_max_i(key);
                const int rsel = ((bestj >> 5) & 1) ? rr1 : rr0;
                const int rv = __shfl_sync(FULL, rsel, bestj & 31);
                const bool extend = best > k_span;
                fi = fmaxf(k_span, best);
                pi = extend ? bestj : -1;
                rooti = extend ? rv : i;
            }
            if (lane == (i & 31)) {
                if ((i >> 5) & 1) {
                    rt1 = ti; rq1 = qi; rs1 = si; rf1 = fi; rr1 = rooti;
                } else {
                    rt0 = ti; rq0 = qi; rs0 = si; rf0 = fi; rr0 = rooti;
                }
            }
            if (lane == k) {
                of = fi;
                op = pi;
                orr = rooti;
            }
        }
        if (a < A) {
            f_out[row + a] = of;
            par_out[row + a] = op;
            root_out[row + a] = orr;
        }
    }
}

}  // namespace

// splice_pen arrives as a C float: the ctypes binding declares it
// c_float (kernels.entry's n_float), so it is not cut to an int on the way.
// max_intron == 0 runs the map-ont instantiation.
extern "C" int chain_dp(const void* t, const void* q, const void* seg,
                        const void* valid, void* f, void* parent, void* root,
                        int B, int A, int k_span, int max_gap, int bandwidth,
                        int max_intron, float splice_pen, void* stream) {
    if (B == 0 || A == 0) return 0;
    const int threads = 128;  // 4 reads per block
    const int blocks = (B + 3) / 4;
    // the plain version's 0.01 * k rounded once to float32
    const float gap_coef = (float)(0.01 * k_span);
    auto kernel = max_intron > 0 ? chain_dp_kernel<true>
                                 : chain_dp_kernel<false>;
    kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)t, (const int*)q, (const int*)seg, (const uint8_t*)valid,
        (float*)f, (int*)parent, (int*)root, B, A, (float)k_span, gap_coef,
        (float)max_gap, (float)bandwidth, (float)max_intron, splice_pen);
    return (int)cudaGetLastError();
}
