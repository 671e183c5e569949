// Streaming fastq(.gz) reader: zlib inflate + record parse + base encoding
// in one native pass, filling caller-provided batch arenas.
//
// Role in the engine: the host-side data loader feeding device batches
// (the reference shards files with seqkit and re-parses them per worker,
// reference pipeline.py:76-151; here one streaming reader produces padded
// int8 code batches directly). The Python parser in io/fastq.py remains
// as the fallback and gives the same batches; this reader keeps the card
// fed once the compute path outruns Python line parsing.
//
// API (ctypes):
//   void* fq_open(const char* path);        // NULL on error
//   int   fq_next_batch(void* h, int batch_size, int max_len,
//                       int8_t* codes,      // (batch_size, max_len), PAD=5
//                       int32_t* lengths,   // (batch_size,)
//                       char* name_buf, int32_t name_cap, int32_t* name_off,
//                       char* qual_buf, int32_t qual_cap, int32_t* qual_off);
//         // returns #records filled (0 = EOF), -2 malformed, -3 caps too
//         // small for even one record. Sequences/quals longer than
//         // max_len are truncated (lengths <= max_len). name_off/qual_off
//         // have batch_size+1 entries (CSR offsets into the buffers).
//   void  fq_close(void* h);
//
// Handles plain and gzipped input (including concatenated gzip members).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

constexpr size_t CHUNK = 1 << 20;

struct Reader {
    FILE* f = nullptr;
    bool is_gz = false;
    z_stream zs{};
    std::vector<unsigned char> in;    // compressed chunk
    size_t in_have = 0;               // bytes in `in` not yet consumed
    bool in_eof = false;
    std::vector<unsigned char> buf;   // decompressed ring (linear, compacted)
    size_t pos = 0;                   // parse cursor
    size_t lim = 0;                   // valid bytes
    bool stream_end = false;
    int8_t code[256];
};

// Refill buf so that at least one full line past `pos` is available (or EOF).
// Returns false on fatal read error.
bool refill(Reader* r) {
    // compact
    if (r->pos > 0) {
        memmove(r->buf.data(), r->buf.data() + r->pos, r->lim - r->pos);
        r->lim -= r->pos;
        r->pos = 0;
    }
    if (r->buf.size() - r->lim < CHUNK)
        r->buf.resize(r->lim + CHUNK * 2);
    if (!r->is_gz) {
        size_t n = fread(r->buf.data() + r->lim, 1, CHUNK, r->f);
        r->lim += n;
        if (n == 0) r->stream_end = true;
        return true;
    }
    // gz path: one inflate round into the spare space
    if (r->in_have == 0 && !r->in_eof) {
        r->in_have = fread(r->in.data(), 1, CHUNK, r->f);
        r->zs.next_in = r->in.data();
        r->zs.avail_in = (uInt)r->in_have;
        if (r->in_have == 0) r->in_eof = true;
    }
    if (r->in_eof && r->zs.avail_in == 0) {
        r->stream_end = true;
        return true;
    }
    r->zs.next_out = r->buf.data() + r->lim;
    r->zs.avail_out = (uInt)(r->buf.size() - r->lim);
    int rc = inflate(&r->zs, Z_NO_FLUSH);
    size_t produced = (r->buf.size() - r->lim) - r->zs.avail_out;
    r->lim += produced;
    r->in_have = r->zs.avail_in;
    if (rc == Z_STREAM_END) {
        // concatenated members: reset and continue with remaining input
        if (inflateReset(&r->zs) != Z_OK) return false;
        if (r->zs.avail_in == 0 && r->in_eof) r->stream_end = true;
        return true;
    }
    if (rc != Z_OK && rc != Z_BUF_ERROR) return false;
    if (rc == Z_BUF_ERROR && produced == 0 && r->zs.avail_in == 0 && r->in_eof)
        r->stream_end = true;
    return true;
}

// Find next '\n' from pos; refill as needed. Returns line [start, end) span
// via out params; false at clean EOF with no data; -1 length on error.
enum LineRc { LINE_OK, LINE_EOF, LINE_ERR };

LineRc next_line(Reader* r, size_t* start, size_t* end) {
    for (;;) {
        unsigned char* nl = (unsigned char*)memchr(
            r->buf.data() + r->pos, '\n', r->lim - r->pos);
        if (nl) {
            *start = r->pos;
            *end = (size_t)(nl - r->buf.data());
            r->pos = *end + 1;
            return LINE_OK;
        }
        if (r->stream_end) {
            if (r->lim > r->pos) {           // final unterminated line
                *start = r->pos;
                *end = r->lim;
                r->pos = r->lim;
                return LINE_OK;
            }
            return LINE_EOF;
        }
        if (!refill(r)) return LINE_ERR;
    }
}

}  // namespace

extern "C" {

void* fq_open(const char* path) {
    Reader* r = new Reader();
    r->f = fopen(path, "rb");
    if (!r->f) { delete r; return nullptr; }
    size_t n = strlen(path);
    r->is_gz = n > 3 && strcmp(path + n - 3, ".gz") == 0;
    if (r->is_gz) {
        r->in.resize(CHUNK);
        if (inflateInit2(&r->zs, 15 + 16) != Z_OK) {
            fclose(r->f);
            delete r;
            return nullptr;
        }
    }
    r->buf.resize(CHUNK * 2);
    for (int i = 0; i < 256; i++) r->code[i] = 4;       // unknown -> N
    r->code[(int)'A'] = r->code[(int)'a'] = 0;
    r->code[(int)'C'] = r->code[(int)'c'] = 1;
    r->code[(int)'G'] = r->code[(int)'g'] = 2;
    r->code[(int)'T'] = r->code[(int)'t'] = 3;
    return r;
}

int fq_next_batch(void* h, int batch_size, int max_len,
                  int8_t* codes, int32_t* lengths,
                  char* name_buf, int32_t name_cap, int32_t* name_off,
                  char* qual_buf, int32_t qual_cap, int32_t* qual_off) {
    Reader* r = (Reader*)h;
    memset(codes, 5, (size_t)batch_size * max_len);     // PAD
    int nb = 0;
    int32_t npos = 0, qpos = 0;
    name_off[0] = 0;
    qual_off[0] = 0;
    while (nb < batch_size) {
        size_t hs, he;
        // remember stream state in case this record overflows the caps
        LineRc rc = next_line(r, &hs, &he);
        if (rc == LINE_EOF) break;
        if (rc == LINE_ERR) return -2;
        if (he == hs) continue;                          // blank line
        if (r->buf[hs] != '@') return -2;
        // name = first whitespace token after '@'
        size_t ns = hs + 1, ne = ns;
        while (ne < he && r->buf[ne] != ' ' && r->buf[ne] != '\t' &&
               r->buf[ne] != '\r')
            ne++;
        int32_t nlen = (int32_t)(ne - ns);
        if (npos + nlen > name_cap) return -3;  // caller sizes caps so this cannot drop a record
        memcpy(name_buf + npos, r->buf.data() + ns, nlen);

        size_t ss, se;
        if (next_line(r, &ss, &se) != LINE_OK) return -2;
        if (se > ss && r->buf[se - 1] == '\r') se--;
        int32_t slen = (int32_t)(se - ss);
        int32_t keep = slen < max_len ? slen : max_len;
        {
            const unsigned char* src = r->buf.data() + ss;
            int8_t* dst = codes + (size_t)nb * max_len;
            for (int32_t i = 0; i < keep; i++) dst[i] = r->code[src[i]];
        }
        lengths[nb] = keep;

        size_t ps, pe;
        if (next_line(r, &ps, &pe) != LINE_OK) return -2;
        if (pe == ps || r->buf[ps] != '+') return -2;

        size_t qs, qe;
        if (next_line(r, &qs, &qe) != LINE_OK) return -2;
        if (qe > qs && r->buf[qe - 1] == '\r') qe--;
        int32_t qlen = (int32_t)(qe - qs);
        if (qlen > max_len) qlen = max_len;              // truncate with seq
        if (qpos + qlen > qual_cap) return -3;
        memcpy(qual_buf + qpos, r->buf.data() + qs, qlen);

        npos += nlen;
        qpos += qlen;
        nb++;
        name_off[nb] = npos;
        qual_off[nb] = qpos;
    }
    return nb;
}

void fq_close(void* h) {
    Reader* r = (Reader*)h;
    if (r->is_gz) inflateEnd(&r->zs);
    if (r->f) fclose(r->f);
    delete r;
}

}  // extern "C"
