// Banded global alignment with traceback → CIGAR, for the BAM output
// boundary (base-level detail the chain stage doesn't produce).
//
// Role in the engine: the device aligner (align/aligner.py) computes chain
// spans; when records are materialized as BAM (reference
// scripts/align_genome.sh + utils.py:801-824 tagging), each record's
// read[qstart:qend] vs ref[tstart:tend] segment is aligned here to emit
// --eqx style =/X/I/D CIGARs like the reference's minimap2 invocation.
// Scoring follows minimap2 map-ont: match +2, mismatch -4, gap open -4,
// gap extend -2 (approximation: single affine class).
//
// Build: runtime/native_lib.py (g++ -O3 -shared -fPIC) at first use. A copy
// of the JAX package's runtime/native/banded_align.cpp.
// API (ctypes, batch-oriented to amortize call overhead):
//   int banded_align_batch(const int8_t* q, const int32_t* q_off, const int32_t* q_len,
//                          const int8_t* t, const int32_t* t_off, const int32_t* t_len,
//                          int n, int band,
//                          char* cigar_out, int32_t cigar_cap,
//                          int32_t* cigar_off, int32_t* scores, int32_t* nm)
// cigar strings are written consecutively; cigar_off[i] = start of record i
// (cigar_off[n] = end). Returns 0 on success, -1 if cigar_cap exceeded.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <algorithm>

namespace {

constexpr int MATCH = 2, MISMATCH = -4, GAP_OPEN = -4, GAP_EXT = -2;
constexpr int NEG = -(1 << 28);

struct Cell { int32_t m, x, y; };  // match/ins(query)/del(ref) lattices

// traceback codes: 2 bits per lattice transition packed into one byte
// per (i, band_col): bits0-1 M-src (0 diag-M,1 diag-X,2 diag-Y)
//                    bit2 X-src (0 open-from-M, 1 extend)
//                    bit3 Y-src

int align_one(const int8_t* q, int lq, const int8_t* t, int lt, int band,
              std::string& cig, int32_t* nm_out) {
    if (lq == 0 && lt == 0) { cig.clear(); *nm_out = 0; return 0; }
    // band center follows the diagonal d(i) = i * lt / max(lq,1)
    band = std::max(band, std::abs(lq - lt) + 16);
    const int bw = 2 * band + 1;
    std::vector<Cell> prev(bw), cur(bw);
    std::vector<uint8_t> tb((size_t)(lq + 1) * bw);
    auto center = [&](int i) { return lq ? (int)((int64_t)i * lt / lq) : 0; };

    // row 0
    {
        int c0 = center(0);
        for (int b = 0; b < bw; b++) {
            int j = c0 - band + b;
            Cell& c = prev[b];
            c.m = c.x = c.y = NEG;
            if (j == 0) c.m = 0;
            else if (j > 0 && j <= lt) c.y = GAP_OPEN + GAP_EXT * j;
        }
    }
    for (int i = 1; i <= lq; i++) {
        int ci = center(i), cp = center(i - 1);
        int shift = ci - cp;
        for (int b = 0; b < bw; b++) {
            int j = ci - band + b;
            Cell& c = cur[b];
            c.m = c.x = c.y = NEG;
            uint8_t& code = tb[(size_t)i * bw + b];
            code = 0;
            if (j < 0 || j > lt) continue;
            // diag: prev row, column j-1 → prev band index
            int bd = b + shift - 1;
            if (j >= 1 && bd >= 0 && bd < bw) {
                const Cell& p = prev[bd];
                int s = (q[i - 1] == t[j - 1] && q[i - 1] < 4) ? MATCH : MISMATCH;
                int best = p.m, src = 0;
                if (p.x > best) { best = p.x; src = 1; }
                if (p.y > best) { best = p.y; src = 2; }
                if (best > NEG / 2) { c.m = best + s; code |= src; }
            } else if (j == 0 && i == 0) {
                c.m = 0;
            }
            // X: consume query base (insertion) from prev row same column
            int bx = b + shift;
            if (bx >= 0 && bx < bw) {
                const Cell& p = prev[bx];
                int open = std::max(p.m, p.y) + GAP_OPEN + GAP_EXT;
                int ext = p.x + GAP_EXT;
                if (ext >= open && ext > NEG / 2) { c.x = ext; code |= 4; }
                else if (open > NEG / 2) c.x = open;
            }
            // Y: consume ref base (deletion) from same row, column j-1
            if (b >= 1 && j >= 1) {
                const Cell& p = cur[b - 1];
                int open = std::max(p.m, p.x) + GAP_OPEN + GAP_EXT;
                int ext = p.y + GAP_EXT;
                if (ext >= open && ext > NEG / 2) { c.y = ext; code |= 8; }
                else if (open > NEG / 2) c.y = open;
            }
        }
        std::swap(prev, cur);
    }
    // terminal at (lq, lt)
    int cl = center(lq);
    int bT = lt - cl + band;
    if (bT < 0 || bT >= bw) { cig.clear(); *nm_out = -1; return NEG; }
    const Cell& T = prev[bT];
    int score = std::max(T.m, std::max(T.x, T.y));
    int state = (score == T.m) ? 0 : (score == T.x ? 1 : 2);

    // traceback
    std::string ops;
    int i = lq, j = lt, nm = 0;
    while (i > 0 || j > 0) {
        int b = j - center(i) + band;
        uint8_t code = tb[(size_t)i * bw + b];
        if (i == 0) { ops.push_back('D'); j--; nm++; continue; }
        if (j == 0) { ops.push_back('I'); i--; nm++; continue; }
        if (state == 0) {
            bool eq = (q[i - 1] == t[j - 1] && q[i - 1] < 4);
            ops.push_back(eq ? '=' : 'X');
            if (!eq) nm++;
            state = code & 3;
            i--; j--;
        } else if (state == 1) {
            ops.push_back('I');
            nm++;
            state = (code & 4) ? 1 : 0;
            i--;
        } else {
            ops.push_back('D');
            nm++;
            state = (code & 8) ? 2 : 0;
            j--;
        }
    }
    // run-length encode reversed ops
    cig.clear();
    char buf[16];
    int n = (int)ops.size();
    int k = n - 1;
    while (k >= 0) {
        char op = ops[k];
        int run = 0;
        while (k >= 0 && ops[k] == op) { run++; k--; }
        snprintf(buf, sizeof buf, "%d%c", run, op);
        cig += buf;
    }
    *nm_out = nm;
    return score;
}

}  // namespace

extern "C" int banded_align_batch(
    const int8_t* q, const int32_t* q_off, const int32_t* q_len,
    const int8_t* t, const int32_t* t_off, const int32_t* t_len,
    int n, int band,
    char* cigar_out, int32_t cigar_cap,
    int32_t* cigar_off, int32_t* scores, int32_t* nm) {
    int64_t pos = 0;
    std::string cig;
    for (int r = 0; r < n; r++) {
        scores[r] = align_one(q + q_off[r], q_len[r], t + t_off[r], t_len[r],
                              band, cig, &nm[r]);
        cigar_off[r] = (int32_t)pos;
        if (pos + (int64_t)cig.size() > cigar_cap) return -1;
        memcpy(cigar_out + pos, cig.data(), cig.size());
        pos += cig.size();
    }
    cigar_off[n] = (int32_t)pos;
    return 0;
}
