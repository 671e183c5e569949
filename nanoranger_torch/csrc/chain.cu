// Windowed colinear chain DP over (seg, t, q)-sorted anchors.
//
// Replaces the JAX package's ops/pallas_chain.py::_chain_kernel (:33). Same
// recurrence as the plain version in nanoranger_torch/ops/chain.py:
// each anchor looks back over the G = 64 previous anchors of its read, only
// valid predecessors of the same seg count, the gap costs
// 0.01*k*dd + 0.5*log2(dd) in float32, the parent is the LAST argmax of the
// window and the chain root is carried along.
//
// Two gap classes, chosen at compile time (template <bool SPLICE>): the
// map-ont class above, and with SPLICE the minimap2 `-x splice` intron
// class beside it: a target gap beyond the band (bandwidth < dt-dq <=
// max_intron) with a small query gap costs
// 0.01*k*dq + splice_pen + 0.5*log2(dt-dq), and the map-ont class wins
// where both admit a predecessor. The map-ont instantiation carries no
// trace of the intron arm.
//
// What bounds it on an H100. Bytes: what the inputs need is the valid flag
// and the three outputs of every slot (13 bytes) and t, q, seg of the
// valid slots only (no other slot changes an output): 0.033 ms at 2048
// reads x 4096 slots with 84k valid anchors, 3.35 TB/s. Time: anchor i
// needs f of the 64 valid or invalid slots before it, so each read is one
// dependent chain, and the read with the most valid anchors sets the
// launch. The design against each:
// - Walk only what a read has. A warp a read finds its end (the last
//   valid slot + 1) from 16-byte loads of the valid row and one warp max,
//   walks 32-slot chunks up to it (one coalesced load a lane, the next
//   chunk prefetched), skips a chunk with no valid slot and steps over the
//   set bits of the chunk's valid ballot only; no prefix of valid slots is
//   assumed. The slots past the end get NEGF, -1, -1 by bulk copies
//   (cp.async.bulk) from shared memory, so the copy engine and not the
//   SM's store path moves most of the bytes.
// - Keep the f chain short. The 64-slot ring lives in registers, two
//   halves of 32: A holds this chunk (lanes below the step) and the chunk
//   two back (lanes at or above it), B the chunk before; a warp-uniform
//   mask per half says which slots hold a valid anchor, so an invalid or
//   stale slot is masked, never rewritten. Everything that does not need
//   f (dt, dq, dd, the band and gap tests, both log2 terms, the class
//   choice) is computed two valid steps ahead; the map-ont log2 reads a
//   shared table. On the f path stay (fw + dg) - gap, a clamp at k, and
//   one redux.sync max: a score at or below k never makes a parent, so
//   clamped scores are positive floats whose bits order as ints, and the
//   max is f itself. The LAST argmax comes from two ballots of the slots
//   that hold the max, rotated into window order, and the roots of a
//   chunk from five rounds of pointer jumping after its last step, off
//   the f path. A step then costs the dispatch of its loop body (~90
//   instructions, ~180 with the intron arm's log2f), more than the one
//   reduction's latency.
//
// Float parity: built with -fmad=false, and the sums use __fadd_rn /
// __fmul_rn in the order of the plain version, with log2f (the table holds
// log2f's own values), so the card's plain torch version and this kernel
// give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEGF = -1e18f;
constexpr int TAIL_WORDS = 1024;   // 4 KB sources of the bulk tail copies
// the log2 table and the two tail sources fit the 48 KB of shared memory a
// block gets without opting in
constexpr int MAX_BANDWIDTH = (48 * 1024 - 8 * TAIL_WORDS) / 4 - 1;

struct Params {
    float k_span, gap_coef, max_gap, bandwidth, max_intron, splice_pen;
    int lg_last;   // the log2 table holds 0..lg_last = max(bandwidth, 0)
};

// the gap of predecessor w for anchor i, +inf where w cannot precede i.
// lg[x] = log2f(max(x, 1)): dd is a whole number and admits w only at
// dd <= bandwidth, so the map-ont term reads the table (the same log2f
// bits); the intron term's dt - dq exceeds the band and keeps log2f.
template <bool SPLICE>
__device__ __forceinline__ void gap_term(const Params& p, const float* lg,
                                         float ti, float qi, int si,
                                         float tw, float qw, int sw,
                                         bool vw, float& dg, float& gap) {
    const float dt = __fsub_rn(ti, tw);
    const float dq = __fsub_rn(qi, qw);
    const float dd = fabsf(__fsub_rn(dq, dt));
    dg = fminf(fminf(dq, dt), p.k_span);
    // no branch: at dd == 0 this is exactly the plain version's 0
    float g = __fadd_rn(__fmul_rn(p.gap_coef, dd),
                        __fmul_rn(0.5f, lg[(int)fminf(dd, (float)p.lg_last)]));
    const bool seg_eq = vw && (sw == si);
    const bool ok_n = seg_eq && (dt > 0.f) && (dq > 0.f) &&
                      (dt <= p.max_gap) && (dq <= p.max_gap) &&
                      (dd <= p.bandwidth);
    bool ok = ok_n;
    if constexpr (SPLICE) {
        const float ds = __fsub_rn(dt, dq);
        const bool ok_s = seg_eq && (dq > 0.f) && (dq <= p.max_gap) &&
                          (ds > p.bandwidth) && (dt <= p.max_intron);
        // (0.01*k*dq + pen) + 0.5*log2(max(dt-dq, 1))
        const float gs = __fadd_rn(
            __fadd_rn(__fmul_rn(p.gap_coef, dq), p.splice_pen),
            __fmul_rn(0.5f, log2f(fmaxf(ds, 1.f))));
        g = ok_n ? g : gs;
        ok = ok_n || ok_s;
    }
    gap = ok ? g : __int_as_float(0x7f800000);
}

// shared -> global copy by the copy engine (bytes a multiple of 16, both
// addresses 16-byte aligned)
__device__ __forceinline__ void bulk_copy(void* dst, unsigned src,
                                          unsigned bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

// one half of the predecessor ring: lane l holds one slot
struct Half {
    float t, q, f;
    int s, r;
    unsigned valid;   // warp-uniform: bit l set if slot l holds a valid anchor
};

// the f-free part of one anchor's window: dg and gap of the lane's slot in
// each half
struct Window {
    float dgA, gapA, dgB, gapB;
};

template <bool SPLICE>
__global__ void __launch_bounds__(128)
chain_dp_kernel(const int* __restrict__ t, const int* __restrict__ q,
                const int* __restrict__ seg,
                const uint8_t* __restrict__ valid, float* __restrict__ f_out,
                int* __restrict__ par_out, int* __restrict__ root_out, int B,
                int A, const Params p) {
    extern __shared__ float lg[];
    __shared__ __align__(16) float negf_buf[TAIL_WORDS];
    __shared__ __align__(16) int neg1_buf[TAIL_WORDS];
    for (int x = threadIdx.x; x <= p.lg_last; x += blockDim.x)
        lg[x] = log2f(fmaxf((float)x, 1.f));
    for (int x = threadIdx.x; x < TAIL_WORDS; x += blockDim.x) {
        negf_buf[x] = NEGF;
        neg1_buf[x] = -1;
    }
    // the bulk copies below read these through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const int read = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (read >= B) return;  // the whole warp leaves together
    const size_t row = (size_t)read * A;
    const int kspan_bits = __float_as_int(p.k_span);   // k_span > 0

    // the read's end: its last valid slot + 1
    int last = -1;
    const uint8_t* vrow = valid + row;
    if (((uintptr_t)vrow & 15) == 0) {
        const uint4* v4 = reinterpret_cast<const uint4*>(vrow);
        const int n4 = A >> 4;
#pragma unroll 8
        for (int x = lane; x < n4; x += 32) {
            const uint4 w = v4[x];
            const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int y = 0; y < 4; ++y)
                last = ws[y] ? x * 16 + y * 4 + ((31 - __clz(ws[y])) >> 3)
                             : last;
        }
        for (int a = (n4 << 4) + lane; a < A; a += 32)
            if (vrow[a]) last = a;
    } else {
        for (int a = lane; a < A; a += 32)
            if (vrow[a]) last = a;
    }
    const int end = __reduce_max_sync(FULL, last) + 1;
    const int n_chunks = (end + 31) >> 5;

    Half ha{0.f, 0.f, NEGF, 0, -1, 0u};  // the chunk two back, then this one
    Half hb{0.f, 0.f, NEGF, 0, -1, 0u};  // the chunk before

    float ct = 0.f, cq = 0.f;
    int cs = 0, cv = 0;
    if (n_chunks > 0 && lane < A) {
        ct = (float)t[row + lane];
        cq = (float)q[row + lane];
        cs = seg[row + lane];
        cv = valid[row + lane];
    }
    for (int c = 0; c < n_chunks; ++c) {
        const int base = c << 5;
        const int a = base + lane;
        // prefetch the next chunk
        float nt = 0.f, nq = 0.f;
        int ns = 0, nv = 0;
        if (c + 1 < n_chunks && a + 32 < A) {
            nt = (float)t[row + a + 32];
            nq = (float)q[row + a + 32];
            ns = seg[row + a + 32];
            nv = valid[row + a + 32];
        }
        const unsigned ballot = __ballot_sync(FULL, cv);
        int op = -1;
        if (ballot) {
            auto window = [&](int k) {
                const float ti = __shfl_sync(FULL, ct, k);
                const float qi = __shfl_sync(FULL, cq, k);
                const int si = __shfl_sync(FULL, cs, k);
                const bool lo = lane < k;   // A's slot: this chunk's anchor
                const bool va = ((lo ? ballot : ha.valid) >> lane) & 1;
                const bool vb = (hb.valid >> lane) & 1;
                Window w;
                gap_term<SPLICE>(p, lg, ti, qi, si, lo ? ct : ha.t,
                                 lo ? cq : ha.q, lo ? cs : ha.s, va, w.dgA,
                                 w.gapA);
                gap_term<SPLICE>(p, lg, ti, qi, si, hb.t, hb.q, hb.s, vb,
                                 w.dgB, w.gapB);
                return w;
            };
            // k: this step's lane, k1 the next valid one, rest the valid
            // lanes after k1; windows are made two steps ahead
            unsigned rest = ballot & (ballot - 1);
            int k = __ffs(ballot) - 1;
            int k1 = rest ? __ffs(rest) - 1 : k;
            rest &= rest - 1;
            Window w = window(k);
            Window w1 = window(k1);
            for (;;) {
                const int k2 = rest ? __ffs(rest) - 1 : k1;
                const Window w2 = window(k2);
                // a score at or below k_span never makes a parent, so the
                // scores clamp there and their bits order as ints
                const int ka = __float_as_int(fmaxf(
                    __fsub_rn(__fadd_rn(ha.f, w.dgA), w.gapA), p.k_span));
                const int kb = __float_as_int(fmaxf(
                    __fsub_rn(__fadd_rn(hb.f, w.dgB), w.gapB), p.k_span));
                const int bk = __reduce_max_sync(FULL, max(ka, kb));
                const bool me = lane == k;
                ha.f = me ? __int_as_float(bk) : ha.f;   // max(k_span, best)
                // ring bit b = lane + 32 * half sits at window offset
                // (b - k) mod 64: rotate the two ballots right by k, and the
                // top set bit is the LAST argmax
                const unsigned ba = __ballot_sync(FULL, ka == bk);
                const unsigned bb = __ballot_sync(FULL, kb == bk);
                const unsigned wlo = __funnelshift_r(ba, bb, k);
                const unsigned whi = __funnelshift_r(bb, ba, k);
                const int off = whi ? 63 - __clz(whi) : 31 - __clz(wlo);
                op = me ? (bk > kspan_bits ? base + k - 64 + off : -1) : op;
                if (k == k1) break;
                k = k1;
                w = w1;
                k1 = k2;
                w1 = w2;
                rest &= rest - 1;
            }
            // roots: a parent in an earlier chunk has its root in the ring
            // (B the chunk before, A's roots still the chunk two back); a
            // parent in this chunk is resolved by five rounds of pointer
            // jumping (chains of at most 31 links inside a chunk)
            const int src = op & 31;
            const int r_b = __shfl_sync(FULL, hb.r, src);
            const int r_a = __shfl_sync(FULL, ha.r, src);
            const bool here = op >= base;
            int r = op < 0 ? a : (here ? -1 : (op >= base - 32 ? r_b : r_a));
            int nxt = here ? src : lane;
#pragma unroll
            for (int s = 0; s < 5; ++s) {
                const int rr = __shfl_sync(FULL, r, nxt);
                const int nn = __shfl_sync(FULL, nxt, nxt);
                nxt = r < 0 ? nn : nxt;
                r = r < 0 ? rr : r;
            }
            ha.r = r;
            ha.t = ct;
            ha.q = cq;
            ha.s = cs;
        }
        ha.valid = ballot;
        if (a < A) {
            f_out[row + a] = cv ? ha.f : NEGF;
            par_out[row + a] = op;
            root_out[row + a] = cv ? ha.r : -1;
        }
        // this chunk becomes the one before; the one before, two back
        const Half h = ha;
        ha = hb;
        hb = h;
        ct = nt;
        cq = nq;
        cs = ns;
        cv = nv;
    }

    // past the end: NEGF, -1, -1, by bulk copies from shared memory (the
    // copy engine moves them; no store passes through the SM's pipes)
    const int from = n_chunks << 5;
    float* frow = f_out + row;
    int* prow = par_out + row;
    int* rrow = root_out + row;
    int a0 = from;
    if ((((uintptr_t)frow | (uintptr_t)prow | (uintptr_t)rrow) & 15) == 0) {
        const int n4 = (A >> 2) << 2;
        if (lane == 0 && from < n4) {
            const unsigned sf = (unsigned)__cvta_generic_to_shared(negf_buf);
            const unsigned si = (unsigned)__cvta_generic_to_shared(neg1_buf);
            for (int x = from; x < n4; x += TAIL_WORDS) {
                const unsigned bytes = 4u * (unsigned)min(TAIL_WORDS, n4 - x);
                bulk_copy(frow + x, sf, bytes);
                bulk_copy(prow + x, si, bytes);
                bulk_copy(rrow + x, si, bytes);
            }
            asm volatile("cp.async.bulk.commit_group;" ::: "memory");
            // the sources must stay until read: the block may end first
            asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        }
        a0 = max(from, n4);
    }
    for (int a = a0 + lane; a < A; a += 32) {
        frow[a] = NEGF;
        prow[a] = -1;
        rrow[a] = -1;
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
    if (k_span <= 0 || bandwidth > MAX_BANDWIDTH)
        return (int)cudaErrorInvalidValue;
    const int threads = 128;  // 4 reads per block
    const int blocks = (B + 3) / 4;
    const int lg_last = bandwidth > 0 ? bandwidth : 0;
    // gap_coef: the plain version's 0.01 * k rounded once to float32
    const Params p{(float)k_span, (float)(0.01 * k_span), (float)max_gap,
                   (float)bandwidth, (float)max_intron, splice_pen, lg_last};
    const size_t smem = sizeof(float) * (p.lg_last + 1);
    auto kernel = max_intron > 0 ? chain_dp_kernel<true>
                                 : chain_dp_kernel<false>;
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        (const int*)t, (const int*)q, (const int*)seg, (const uint8_t*)valid,
        (float*)f, (int*)parent, (int*)root, B, A, p);
    return (int)cudaGetLastError();
}
