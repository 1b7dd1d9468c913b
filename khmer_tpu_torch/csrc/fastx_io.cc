// Native FASTA/FASTQ parsing and 2-bit packing for the port's host side
// (khmer_tpu_torch/io/native.py): record splitting, sequence cleaning
// (acgt -> upper, other -> A) and 2-bit encoding, back to back, with each
// record's offsets. A copy of the JAX package's parser, so that the port
// builds and loads only its own code; built with g++ at first use by
// khmer_tpu_torch/ops/host.py.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

// ASCII -> 2-bit code with _to_valid_dna cleaning: A=0, T=1, C=2, G=3,
// anything else -> A(0).  (reference: include/oxli/kmer_hash.hh:62-96,
// src/oxli/read_parsers.cc:53-69)
struct CodeTable {
    uint8_t tbl[256];
    CodeTable() {
        std::memset(tbl, 0, sizeof(tbl));
        tbl[(int)'A'] = 0; tbl[(int)'a'] = 0;
        tbl[(int)'T'] = 1; tbl[(int)'t'] = 1;
        tbl[(int)'C'] = 2; tbl[(int)'c'] = 2;
        tbl[(int)'G'] = 3; tbl[(int)'g'] = 3;
    }
};
static const CodeTable kCodes;

inline const char* find_nl(const char* p, const char* end) {
    const char* nl = (const char*)std::memchr(p, '\n', end - p);
    return nl ? nl : end;
}

}  // namespace

extern "C" {

// Parse a FASTQ text buffer; emit cleaned 2-bit codes back-to-back plus
// per-record (seq_offset, seq_len, name_offset, name_len) quads.
//
// Returns the number of records parsed, or -1 on malformed input.
// codes must hold >= len bytes; meta must hold >= 4 * max_records i64.
// consumed gets the number of input bytes fully processed (so callers
// can stream partial buffers).
long long fastq_pack(const char* buf, long long len,
                     uint8_t* codes, long long* meta,
                     long long max_records, long long* consumed,
                     long long* codes_used) {
    const char* p = buf;
    const char* end = buf + len;
    long long n = 0;
    long long cpos = 0;
    *consumed = 0;
    *codes_used = 0;

    while (p < end && n < max_records) {
        // skip blank lines
        while (p < end && (*p == '\n' || *p == '\r')) p++;
        if (p >= end) break;
        if (*p != '@') return -1;
        const char* name_start = p + 1;
        const char* nl = find_nl(p, end);
        if (nl == end) break;  // partial record
        long long name_len = nl - name_start;
        if (name_len > 0 && name_start[name_len - 1] == '\r') name_len--;

        // sequence (single line in the common case; loop to '+')
        const char* sp = nl + 1;
        long long seq_start_code = cpos;
        const char* q = sp;
        bool complete = false;
        while (q < end) {
            if (*q == '+') { complete = true; break; }
            const char* snl = find_nl(q, end);
            if (snl == end) break;
            for (const char* c = q; c < snl; c++) {
                if (*c != '\r') codes[cpos++] = kCodes.tbl[(uint8_t)*c];
            }
            q = snl + 1;
        }
        if (!complete) { break; }
        long long seq_len = cpos - seq_start_code;

        // '+' line
        const char* pnl = find_nl(q, end);
        if (pnl == end) break;
        // quality lines: consume seq_len quality characters
        const char* r = pnl + 1;
        long long qlen = 0;
        while (r < end && qlen < seq_len) {
            const char* qnl = find_nl(r, end);
            if (qnl == end && (qnl - r) + qlen < seq_len) { r = end; break; }
            for (const char* c = r; c < qnl && qlen < seq_len; c++) {
                if (*c != '\r') qlen++;
            }
            r = (qnl == end) ? end : qnl + 1;
        }
        if (qlen < seq_len) { cpos = seq_start_code; break; }  // partial

        meta[4 * n + 0] = seq_start_code;
        meta[4 * n + 1] = seq_len;
        meta[4 * n + 2] = name_start - buf;
        meta[4 * n + 3] = name_len;
        n++;
        p = r;
        *consumed = p - buf;
        *codes_used = cpos;
    }
    return n;
}

// Parse a FASTA text buffer (multi-line sequences).
long long fasta_pack(const char* buf, long long len,
                     uint8_t* codes, long long* meta,
                     long long max_records, long long* consumed,
                     long long* codes_used) {
    const char* p = buf;
    const char* end = buf + len;
    long long n = 0;
    long long cpos = 0;
    *consumed = 0;
    *codes_used = 0;

    while (p < end && n < max_records) {
        while (p < end && (*p == '\n' || *p == '\r')) p++;
        if (p >= end) break;
        if (*p != '>') return -1;
        const char* name_start = p + 1;
        const char* nl = find_nl(p, end);
        if (nl == end) break;
        long long name_len = nl - name_start;
        if (name_len > 0 && name_start[name_len - 1] == '\r') name_len--;

        const char* q = nl + 1;
        long long seq_start_code = cpos;
        const char* record_end = q;
        while (q < end && *q != '>') {
            const char* snl = find_nl(q, end);
            for (const char* c = q; c < snl; c++) {
                if (*c != '\r' && *c != '\n')
                    codes[cpos++] = kCodes.tbl[(uint8_t)*c];
            }
            if (snl == end) { record_end = end; q = end; break; }
            q = snl + 1;
            record_end = q;
        }
        // a FASTA record is only complete at '>' or true EOF; the
        // caller passes eof=affinity by flushing the final buffer fully
        meta[4 * n + 0] = seq_start_code;
        meta[4 * n + 1] = cpos - seq_start_code;
        meta[4 * n + 2] = name_start - buf;
        meta[4 * n + 3] = name_len;
        n++;
        p = record_end;
        *consumed = p - buf;
        *codes_used = cpos;
    }
    return n;
}

}  // extern "C"
