// Dense canonical window hashes of packed reads, on the host: the k-mers
// the counting and tagging paths commit on the card
// (khmer_tpu_torch/core/hostengine.py). A copy of the JAX package's
// hg_hash_dense and hg_hash_dense_reads with their two families: family 0,
// the reversible 2-bit rolling hash of the graphs; family 1, the murmur
// hash of the Counttable, SmallCounttable and Nodetable. Built with g++ at
// first use by khmer_tpu_torch/ops/host.py.
//
// Codes are A=0, T=1, C=2, G=3 (fastx_io.cc), so a base's complement is
// its code ^ 1. 2-bit: the forward word f of a window holds its first base
// in the high bits, the reverse-complement word r its complement in the
// low bits (reference src/oxli/kmer_hash.cc:65-150); the hash is
// min(f, r). Murmur: MurmurHash3_x64_128 (seed 0, its low 64 bits) of the
// window's bases as text, h, and of its reverse complement, r; the hash is
// h ^ r, or h for a window that is its own reverse complement (reference
// kmer_hash.cc:168-198).

#include <cstdint>
#include <cstring>

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

inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

// The low 64 bits of MurmurHash3_x64_128 (seed 0) of len bytes.
uint64_t murmur128_lo(const uint8_t* data, int len) {
  const int nblocks = len / 16;
  uint64_t h1 = 0, h2 = 0;
  const uint64_t c1 = 0x87c37b91114253d5ULL;
  const uint64_t c2 = 0x4cf5ad432745937fULL;
  for (int i = 0; i < nblocks; i++) {
    uint64_t k1, k2;
    std::memcpy(&k1, data + 16 * i, 8);
    std::memcpy(&k2, data + 16 * i + 8, 8);
    k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
    k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
    h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
  }
  const uint8_t* tail = data + nblocks * 16;
  uint64_t k1 = 0, k2 = 0;
  switch (len & 15) {
    case 15: k2 ^= static_cast<uint64_t>(tail[14]) << 48; [[fallthrough]];
    case 14: k2 ^= static_cast<uint64_t>(tail[13]) << 40; [[fallthrough]];
    case 13: k2 ^= static_cast<uint64_t>(tail[12]) << 32; [[fallthrough]];
    case 12: k2 ^= static_cast<uint64_t>(tail[11]) << 24; [[fallthrough]];
    case 11: k2 ^= static_cast<uint64_t>(tail[10]) << 16; [[fallthrough]];
    case 10: k2 ^= static_cast<uint64_t>(tail[9]) << 8; [[fallthrough]];
    case 9:
      k2 ^= static_cast<uint64_t>(tail[8]);
      k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
      [[fallthrough]];
    case 8: k1 ^= static_cast<uint64_t>(tail[7]) << 56; [[fallthrough]];
    case 7: k1 ^= static_cast<uint64_t>(tail[6]) << 48; [[fallthrough]];
    case 6: k1 ^= static_cast<uint64_t>(tail[5]) << 40; [[fallthrough]];
    case 5: k1 ^= static_cast<uint64_t>(tail[4]) << 32; [[fallthrough]];
    case 4: k1 ^= static_cast<uint64_t>(tail[3]) << 24; [[fallthrough]];
    case 3: k1 ^= static_cast<uint64_t>(tail[2]) << 16; [[fallthrough]];
    case 2: k1 ^= static_cast<uint64_t>(tail[1]) << 8; [[fallthrough]];
    case 1:
      k1 ^= static_cast<uint64_t>(tail[0]);
      k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
  }
  h1 ^= static_cast<uint64_t>(len);
  h2 ^= static_cast<uint64_t>(len);
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  return h1 + h2;
}

constexpr char kBase[4] = {'A', 'T', 'C', 'G'};

// The canonical murmur hash of the k codes at c (fwd, rev: room for k).
uint64_t murmur_canonical(const uint8_t* c, int k, char* fwd, char* rev) {
  bool self_complement = true;
  for (int i = 0; i < k; i++) {
    fwd[i] = kBase[c[i]];
    const uint8_t rc = c[k - 1 - i] ^ 1;
    rev[i] = kBase[rc];
    if (rc != c[i]) self_complement = false;
  }
  const uint64_t h = murmur128_lo(reinterpret_cast<const uint8_t*>(fwd), k);
  if (self_complement) return h;
  return h ^ murmur128_lo(reinterpret_cast<const uint8_t*>(rev), k);
}

// The hashes of one run of codes [c, c + len), len >= k, in family
// `family` (0: 2-bit, 1: murmur), written at out.
long long hash_run(const Roller& R, int family, const uint8_t* c,
                   long long len, uint64_t* out) {
  long long w = 0;
  if (family != 0) {
    char fwd[64], rev[64];
    for (long long i = 0; i + R.k <= len; i++) {
      out[w++] = murmur_canonical(c + i, R.k, fwd, rev);
    }
    return w;
  }
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

// The hashes of a flat chunk of nfill codes in stream order, in family
// `family` (0: 2-bit, 1: murmur). `starts` are the ascending read-start
// offsets in it (entries >= nfill are ignored); no window spans a read
// start. Returns the number written.
long long kt_hash_dense(const uint8_t* codes, long long nfill,
                        const int32_t* starts, long long nstarts, int k,
                        int family, uint64_t* out) {
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
    if (end - seg >= k) {
      w += hash_run(R, family, codes + seg, end - seg, out + w);
    }
    seg = end;
  }
  return w;
}

// The hashes of the reads (offs[i], lens[i]) of a parser block, in read
// order, in family `family`; reads shorter than k give none. Returns the
// number written.
long long kt_hash_dense_reads(const uint8_t* codes, const int64_t* offs,
                              const int64_t* lens, long long n_reads, int k,
                              int family, uint64_t* out) {
  long long w = 0;
  const Roller R(k);
  for (long long i = 0; i < n_reads; i++) {
    if (lens[i] >= k) {
      w += hash_run(R, family, codes + offs[i], lens[i], out + w);
    }
  }
  return w;
}

}  // extern "C"
