"""SAM/BAM output boundary — pure-python BGZF/BAM writer (htslib-free).

The engine keeps alignments columnar (align/aligner.py AlignmentRecords);
real SAM/BAM is materialized only at the output boundary for compatibility
with downstream consumers of the reference's `_genome_tagged.bam`
(utils.py:801-824, scripts/downstream/*). No pysam/htslib exists in this
environment, so BGZF blocks are produced with zlib directly.

A copy of the JAX package's io/bam.py (host code).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# 4-bit base codes of BAM's "=ACMGRSVTWYHKDBN" alphabet for our A,C,G,T,N,PAD
_SEQ4 = {0: 1, 1: 2, 2: 4, 3: 8, 4: 15, 5: 15}
_CIGAR_OPS = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6,
              "=": 7, "X": 8}

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


class BGZFWriter:
    """tmp+rename on close: an existing BAM is always complete (safe
    resume-on-existence; see io/fastq.FastqWriter)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._final_path = path
        self._tmp = path + ".tmp"
        self._f = open(self._tmp, "wb")
        self._buf = bytearray()
        self._coffset = 0      # compressed bytes written (= next block start)

    def tell_virtual(self) -> int:
        """BAM virtual file offset of the next byte to be written
        (coffset of the block it will land in << 16 | offset within)."""
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes):
        self._buf += data
        while len(self._buf) >= 60000:
            self._flush_block(self._buf[:60000])
            del self._buf[:60000]

    def _flush_block(self, chunk):
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(bytes(chunk)) + co.flush()
        # BSIZE extra field = total block length - 1
        # (12B gzip hdr + 6B extra + comp + 8B crc/isize)
        bsize_m1 = 12 + 6 + len(comp) + 8 - 1
        header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                  b"\x06\x00" b"\x42\x43" b"\x02\x00" +
                  struct.pack("<H", bsize_m1))
        crc = zlib.crc32(bytes(chunk)) & 0xFFFFFFFF
        block = header + comp + struct.pack("<II", crc, len(chunk))
        self._f.write(block)
        self._coffset += len(block)

    def close(self):
        if self._buf:
            self._flush_block(self._buf)
            self._buf = bytearray()
        self._f.write(BGZF_EOF)
        self._f.close()
        os.replace(self._tmp, self._final_path)


def _encode_cigar(cigar: list[tuple[int, str]]) -> bytes:
    out = b""
    for n, op in cigar:
        out += struct.pack("<I", (n << 4) | _CIGAR_OPS[op])
    return out


def _pack_seq(codes: np.ndarray) -> bytes:
    n = len(codes)
    out = bytearray((n + 1) // 2)
    for i in range(n):
        v = _SEQ4[int(codes[i])]
        if i % 2 == 0:
            out[i // 2] = v << 4
        else:
            out[i // 2] |= v
    return bytes(out)


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BAMWriter:
    """Minimal coordinate-order BAM writer with Z/i tags.

    With index=True a .bai (BAI binning + linear index, SAM spec §5.1.3)
    is written on close so samtools/IGV can random-access the output —
    records must be added in coordinate order."""

    def __init__(self, path: str, ref_names: list, ref_lens: list,
                 extra_header: str = "", index: bool = False):
        self._path = path
        self._index = index
        self._chunks = []      # (ref_id, pos, end, vbeg, vend)
        self._n_ref = len(ref_names)
        self._w = BGZFWriter(path)
        text = "@HD\tVN:1.6\tSO:coordinate\n"
        for n, l in zip(ref_names, ref_lens):
            text += f"@SQ\tSN:{n}\tLN:{int(l)}\n"
        text += extra_header
        hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode()
        hdr += struct.pack("<i", len(ref_names))
        for n, l in zip(ref_names, ref_lens):
            nb = n.encode() + b"\x00"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(l))
        self._w.write(hdr)

    def write(self, name: str, flag: int, ref_id: int, pos: int, mapq: int,
              cigar: list, seq_codes: np.ndarray, qual: bytes | None,
              tags: dict | None = None):
        nb = name.encode() + b"\x00"
        cig = _encode_cigar(cigar)
        seq = _pack_seq(seq_codes)
        l_seq = len(seq_codes)
        if qual is None:
            q = b"\xff" * l_seq
        else:
            q = bytes(max(0, c - 33) for c in qual[:l_seq])
            q += b"\x00" * (l_seq - len(q))
        tag_b = b""
        for k, v in (tags or {}).items():
            if isinstance(v, str):
                tag_b += k.encode() + b"Z" + v.encode() + b"\x00"
            else:
                tag_b += k.encode() + b"i" + struct.pack("<i", int(v))
        ref_span = sum(n for n, op in cigar if op in "MDN=X") or 1
        body = struct.pack("<iiBBHHHiiii", ref_id, pos, len(nb), mapq,
                           _reg2bin(pos, pos + ref_span), len(cigar), flag,
                           l_seq, -1, -1, 0)
        body += nb + cig + seq + q + tag_b
        vbeg = self._w.tell_virtual()
        self._w.write(struct.pack("<i", len(body)) + body)
        if self._index:
            self._chunks.append((ref_id, pos, pos + ref_span, vbeg,
                                 self._w.tell_virtual()))

    def close(self):
        self._w.close()
        if self._index:
            self._write_bai()

    def _write_bai(self):
        out = bytearray(b"BAI\x01" + struct.pack("<i", self._n_ref))
        by_ref: dict = {}
        for ref_id, pos, end, vb, ve in self._chunks:
            by_ref.setdefault(ref_id, []).append((pos, end, vb, ve))
        for rid in range(self._n_ref):
            recs = by_ref.get(rid, [])
            bins: dict = {}
            max_end = 0
            for pos, end, vb, ve in recs:
                b = _reg2bin(pos, end)
                ch = bins.setdefault(b, [])
                if ch and ch[-1][1] == vb:       # merge adjacent chunks
                    ch[-1] = (ch[-1][0], ve)
                else:
                    ch.append((vb, ve))
                max_end = max(max_end, end)
            out += struct.pack("<i", len(bins))
            for b in sorted(bins):
                out += struct.pack("<Ii", b, len(bins[b]))
                for vb, ve in bins[b]:
                    out += struct.pack("<QQ", vb, ve)
            # linear index: per 16kb window, min voffset of overlapping recs
            n_intv = (max_end + 16383) // 16384 if recs else 0
            ioff = [0] * n_intv
            for pos, end, vb, ve in recs:
                for w in range(pos // 16384, (max(end - 1, pos)) // 16384 + 1):
                    if ioff[w] == 0 or vb < ioff[w]:
                        ioff[w] = vb
            # fill zero gaps with the previous value (samtools convention)
            last = 0
            for w in range(n_intv):
                if ioff[w] == 0:
                    ioff[w] = last
                last = ioff[w]
            out += struct.pack("<i", n_intv)
            for v in ioff:
                out += struct.pack("<Q", v)
        with open(self._path + ".bai", "wb") as f:
            f.write(bytes(out))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------------------
# BAM reading (for the downstream utilities; htslib-free)

_SEQ4_REV = "=ACMGRSVTWYHKDBN"
_CIGAR_OPS_REV = "MIDNSHP=X"


class BamRecord:
    __slots__ = ("name", "flag", "ref_id", "pos", "mapq", "cigar", "seq",
                 "qual", "tags")

    def __init__(self, name, flag, ref_id, pos, mapq, cigar, seq, qual, tags):
        self.name = name
        self.flag = flag
        self.ref_id = ref_id
        self.pos = pos
        self.mapq = mapq
        self.cigar = cigar        # list[(n, op_char)]
        self.seq = seq            # str
        self.qual = qual          # list[int] phred
        self.tags = tags          # dict

    @property
    def reference_end(self) -> int:
        return self.pos + sum(n for n, op in self.cigar if op in "MDN=X")

    @property
    def query_alignment_length(self) -> int:
        return sum(n for n, op in self.cigar if op in "MI=X")

    def aligned_pairs(self):
        """[(qpos|None, rpos|None), ...] like pysam.aligned_pairs."""
        out = []
        qi, ri = 0, self.pos
        for n, op in self.cigar:
            if op in "M=X":
                for _ in range(n):
                    out.append((qi, ri))
                    qi += 1
                    ri += 1
            elif op == "I":
                for _ in range(n):
                    out.append((qi, None))
                    qi += 1
            elif op == "S":
                qi += n                    # soft clips are not aligned pairs
            elif op in "DN":
                for _ in range(n):
                    out.append((None, ri))
                    ri += 1
        return out

    def query_pos_at(self, rpos: int):
        """Query index aligned (match/mismatch) at reference position rpos,
        plus the following indel length (pysam pileupread.indel semantics:
        inserted bases after this column > 0, deletion < 0)."""
        qi, ri = 0, self.pos
        cig = self.cigar
        for k, (n, op) in enumerate(cig):
            if op in "M=X":
                if ri <= rpos < ri + n:
                    q = qi + (rpos - ri)
                    indel = 0
                    if rpos == ri + n - 1 and k + 1 < len(cig):
                        nn, nop = cig[k + 1]
                        if nop == "I":
                            indel = nn
                        elif nop in "DN":
                            indel = -nn
                    return q, indel
                qi += n
                ri += n
            elif op in "IS":
                qi += n
            elif op in "DN":
                if ri <= rpos < ri + n:
                    return None, 0          # deleted at this column
                ri += n
        return None, 0

    def overlap(self, start: int, end: int) -> int:
        """Aligned (M/=/X) bases within [start, end) — pysam get_overlap."""
        ov = 0
        qi, ri = 0, self.pos
        for n, op in self.cigar:
            if op in "M=X":
                ov += max(0, min(ri + n, end) - max(ri, start))
                ri += n
                qi += n
            elif op in "IS":
                qi += n
            elif op in "DN":
                ri += n
        return ov


def _bgzf_decompress(path: str) -> bytes:
    import gzip
    with gzip.open(path, "rb") as f:    # BGZF is valid multi-member gzip
        return f.read()


def read_bam(path: str):
    """Parse a BAM file → (ref_names, ref_lens, iterator of BamRecord)."""
    raw = _bgzf_decompress(path)
    assert raw[:4] == b"BAM\x01", "not a BAM file"
    l_text = struct.unpack("<i", raw[4:8])[0]
    off = 8 + l_text
    n_ref = struct.unpack("<i", raw[off:off + 4])[0]
    off += 4
    ref_names, ref_lens = [], []
    for _ in range(n_ref):
        ln = struct.unpack("<i", raw[off:off + 4])[0]
        ref_names.append(raw[off + 4:off + 4 + ln - 1].decode())
        ref_lens.append(struct.unpack("<i", raw[off + 4 + ln:off + 8 + ln])[0])
        off += 8 + ln

    def records():
        o = off
        while o < len(raw):
            bs = struct.unpack("<i", raw[o:o + 4])[0]
            rec = raw[o + 4:o + 4 + bs]
            o += 4 + bs
            ref_id, pos = struct.unpack("<ii", rec[:8])
            l_rn = rec[8]
            mapq = rec[9]
            n_cig = struct.unpack("<H", rec[12:14])[0]
            flag = struct.unpack("<H", rec[14:16])[0]
            l_seq = struct.unpack("<i", rec[16:20])[0]
            p = 32
            name = rec[p:p + l_rn - 1].decode()
            p += l_rn
            cigar = []
            for _ in range(n_cig):
                v = struct.unpack("<I", rec[p:p + 4])[0]
                cigar.append((v >> 4, _CIGAR_OPS_REV[v & 0xF]))
                p += 4
            seq = "".join(
                _SEQ4_REV[(rec[p + i // 2] >> (4 if i % 2 == 0 else 0)) & 0xF]
                for i in range(l_seq))
            p += (l_seq + 1) // 2
            qual = list(rec[p:p + l_seq])
            p += l_seq
            tags = {}
            while p < len(rec):
                key = rec[p:p + 2].decode()
                typ = chr(rec[p + 2])
                p += 3
                if typ == "Z":
                    e = rec.index(0, p)
                    tags[key] = rec[p:e].decode()
                    p = e + 1
                elif typ in "iI":
                    tags[key] = struct.unpack("<i", rec[p:p + 4])[0]
                    p += 4
                elif typ in "cC":
                    tags[key] = rec[p]
                    p += 1
                elif typ in "sS":
                    tags[key] = struct.unpack("<h", rec[p:p + 2])[0]
                    p += 2
                elif typ == "f":
                    tags[key] = struct.unpack("<f", rec[p:p + 4])[0]
                    p += 4
                elif typ == "A":
                    tags[key] = chr(rec[p])
                    p += 1
                else:
                    break  # unsupported array tag: stop parsing this record
            yield BamRecord(name, flag, ref_id, pos, mapq, cigar, seq,
                            qual, tags)

    return ref_names, ref_lens, records()


class SAMWriter:
    """Plain-text SAM (for _trns.sam / _matching.sam artifact parity)."""

    def __init__(self, path: str, ref_names: list, ref_lens: list):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "w")
        self._f.write("@HD\tVN:1.6\n")
        for n, l in zip(ref_names, ref_lens):
            self._f.write(f"@SQ\tSN:{n}\tLN:{int(l)}\n")

    def write(self, name, flag, ref_name, pos, mapq, cigar_str, seq, qual,
              tags: dict | None = None):
        t = "".join(
            f"\t{k}:{'Z' if isinstance(v, str) else 'i'}:{v}"
            for k, v in (tags or {}).items())
        self._f.write(f"{name}\t{flag}\t{ref_name}\t{pos + 1}\t{mapq}\t"
                      f"{cigar_str}\t*\t0\t0\t{seq}\t{qual}{t}\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
