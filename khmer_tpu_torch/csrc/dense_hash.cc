// Dense canonical 2-bit window hashes of packed reads, on the host: the
// k-mers the counting and tagging paths commit on the card
// (khmer_tpu_torch/core/hostengine.py). A copy of the JAX package's
// hg_hash_dense and hg_hash_dense_reads with their rolling hash, 2-bit
// family only (the port hashes nothing else here); built with g++ at first
// use by khmer_tpu_torch/ops/host.py.
//
// Codes are A=0, T=1, C=2, G=3 (fastx_io.cc). The forward word f of a
// window holds its first base in the high bits, the reverse-complement word
// r its complement in the low bits (reference src/oxli/kmer_hash.cc:65-150);
// the hash is min(f, r).

#include <cstdint>

namespace {

struct Roller {
  uint64_t mask;
  int shift;
  int k;
  explicit Roller(int k_) : k(k_) {
    mask = (k_ >= 32) ? ~0ULL : ((1ULL << (2 * k_)) - 1);
    shift = 2 * k_ - 2;
  }
  void seed(const uint8_t* c, uint64_t& f, uint64_t& r) const {
    f = 0;
    r = 0;
    for (int i = 0; i < k; i++) {
      f = (f << 2) | c[i];
      r |= static_cast<uint64_t>(c[i] ^ 1) << (2 * i);
    }
  }
  void step(uint8_t c, uint64_t& f, uint64_t& r) const {
    f = ((f << 2) | c) & mask;
    r = (r >> 2) | (static_cast<uint64_t>(c ^ 1) << shift);
  }
};

// The hashes of one run of codes [c, c + len), len >= k, written at out.
long long hash_run(const Roller& R, const uint8_t* c, long long len,
                   uint64_t* out) {
  long long w = 0;
  uint64_t f, r;
  R.seed(c, f, r);
  out[w++] = f < r ? f : r;
  for (long long i = R.k; i < len; i++) {
    R.step(c[i], f, r);
    out[w++] = f < r ? f : r;
  }
  return w;
}

}  // namespace

extern "C" {

// The hashes of a flat chunk of nfill codes in stream order. `starts` are
// the ascending read-start offsets in it (entries >= nfill are ignored); no
// window spans a read start. Returns the number written.
long long kt_hash_dense(const uint8_t* codes, long long nfill,
                        const int32_t* starts, long long nstarts, int k,
                        uint64_t* out) {
  long long w = 0;
  const Roller R(k);
  long long si = 0;
  long long seg = 0;
  while (seg < nfill) {
    while (si < nstarts && static_cast<long long>(starts[si]) <= seg) si++;
    const long long end =
        (si < nstarts && static_cast<long long>(starts[si]) < nfill)
            ? static_cast<long long>(starts[si])
            : nfill;
    if (end - seg >= k) w += hash_run(R, codes + seg, end - seg, out + w);
    seg = end;
  }
  return w;
}

// The hashes of the reads (offs[i], lens[i]) of a parser block, in read
// order; reads shorter than k give none. Returns the number written.
long long kt_hash_dense_reads(const uint8_t* codes, const int64_t* offs,
                              const int64_t* lens, long long n_reads, int k,
                              uint64_t* out) {
  long long w = 0;
  const Roller R(k);
  for (long long i = 0; i < n_reads; i++) {
    if (lens[i] >= k) w += hash_run(R, codes + offs[i], lens[i], out + w);
  }
  return w;
}

}  // extern "C"
