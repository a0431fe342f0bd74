// SAM record formatter — the byte-assembly half of the reference's
// MatchesWriter (src/mapper_writer.h [U]). Field SEMANTICS (flags, MAPQ,
// positions, mate fields, tag payloads) are decided in Python
// (pipeline/writer.py); this routine only turns per-record arrays into SAM
// text fast (integer printing and memcpy dominate the Python writer loop).
//
// Build: g++ -O3 -march=native -shared -fPIC samfmt.cpp -o libdysamfmt.so

#include <cstdint>
#include <cstring>

namespace {

inline char* put_int(char* p, int64_t v) {
    if (v < 0) { *p++ = '-'; v = -v; }
    char tmp[20];
    int k = 0;
    do { tmp[k++] = char('0' + v % 10); v /= 10; } while (v);
    while (k) *p++ = tmp[--k];
    return p;
}

inline char* put_mem(char* p, const uint8_t* s, int64_t len) {
    std::memcpy(p, s, size_t(len));
    return p + len;
}

}  // namespace

extern "C" {

// Generic SAM line assembly (SE and PE primaries).
// rnext_idx: contig index, -1 => "*", -2 => "=".
// Returns bytes written, or -1 if out_cap is too small.
int64_t dy_format_records(
    int32_t n,
    const uint8_t* names, const int64_t* name_off,
    const int32_t* flag, const int32_t* rname_idx, const int64_t* pos1,
    const int32_t* mapq,
    const uint8_t* cig, const int64_t* cig_off,
    const int32_t* rnext_idx, const int64_t* pnext, const int64_t* tlen,
    const uint8_t* seqmat, int64_t seq_stride,
    const int32_t* seq_row, const int32_t* seq_len, int32_t seq_codes,
    const uint8_t* quals, const int64_t* qual_off, const uint8_t* qual_rev,
    const uint8_t* has_nm, const int32_t* nm,
    const uint8_t* extra, const int64_t* extra_off,
    const uint8_t* cnames, const int64_t* cname_off,
    uint8_t* out, int64_t cap) {
    char* p = reinterpret_cast<char*>(out);
    char* lim = p + cap;

    for (int32_t i = 0; i < n; i++) {
        // Exact upper bound per record: every variable-length field is
        // counted at its real size (contig names are untrusted FASTA headers
        // and can be arbitrarily long); 128 covers the fixed fields (tabs,
        // 5 integers <= 20 chars with sign, NM tag, '*' placeholders, '\n').
        int64_t rname_len =
            rname_idx[i] >= 0 ? cname_off[rname_idx[i] + 1] - cname_off[rname_idx[i]] : 1;
        int64_t rnext_len =
            rnext_idx[i] >= 0 ? cname_off[rnext_idx[i] + 1] - cname_off[rnext_idx[i]] : 1;
        int64_t need = (name_off[i + 1] - name_off[i]) + rname_len + rnext_len +
                       (cig_off[i + 1] - cig_off[i]) + seq_len[i] +
                       (qual_off[i + 1] - qual_off[i]) +
                       (extra_off[i + 1] - extra_off[i]) + 128;
        if (p + need > lim) return -1;

        p = put_mem(p, names + name_off[i], name_off[i + 1] - name_off[i]);
        *p++ = '\t';
        p = put_int(p, flag[i]);
        *p++ = '\t';
        if (rname_idx[i] < 0) {
            *p++ = '*';
        } else {
            int32_t c = rname_idx[i];
            p = put_mem(p, cnames + cname_off[c], cname_off[c + 1] - cname_off[c]);
        }
        *p++ = '\t';
        p = put_int(p, pos1[i]);
        *p++ = '\t';
        p = put_int(p, mapq[i]);
        *p++ = '\t';
        if (cig_off[i + 1] == cig_off[i]) *p++ = '*';
        else p = put_mem(p, cig + cig_off[i], cig_off[i + 1] - cig_off[i]);
        *p++ = '\t';
        if (rnext_idx[i] == -1) {
            *p++ = '*';
        } else if (rnext_idx[i] == -2) {
            *p++ = '=';
        } else {
            int32_t c = rnext_idx[i];
            p = put_mem(p, cnames + cname_off[c], cname_off[c + 1] - cname_off[c]);
        }
        *p++ = '\t';
        p = put_int(p, pnext[i]);
        *p++ = '\t';
        p = put_int(p, tlen[i]);
        *p++ = '\t';
        if (seq_len[i] == 0) {  // secondary records carry SEQ '*'
            *p++ = '*';
        } else if (seq_codes) {
            // seqmat holds 2-bit codes (0..3 ACGT, 4 N): translate while
            // copying — saves the Python-side code_to_ascii materialization
            static const char lut[8] = {'A', 'C', 'G', 'T', 'N', 'N', 'N', 'N'};
            const uint8_t* s = seqmat + int64_t(seq_row[i]) * seq_stride;
            for (int32_t k = 0; k < seq_len[i]; k++) *p++ = lut[s[k] & 7];
        } else {
            p = put_mem(p, seqmat + int64_t(seq_row[i]) * seq_stride, seq_len[i]);
        }
        *p++ = '\t';
        int64_t ql = qual_off[i + 1] - qual_off[i];
        if (ql == 0) {
            *p++ = '*';
        } else if (qual_rev[i]) {
            const uint8_t* q = quals + qual_off[i];
            for (int64_t k = ql - 1; k >= 0; k--) *p++ = char(q[k]);
        } else {
            p = put_mem(p, quals + qual_off[i], ql);
        }
        if (has_nm[i]) {
            std::memcpy(p, "\tNM:i:", 6);
            p += 6;
            p = put_int(p, nm[i]);
        }
        p = put_mem(p, extra + extra_off[i], extra_off[i + 1] - extra_off[i]);
        *p++ = '\n';
    }
    return p - reinterpret_cast<char*>(out);
}

}  // extern "C"
