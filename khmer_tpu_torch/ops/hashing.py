"""K-mer hashing: the 2-bit codec, the reversible hash and MurmurHash3.

Counterpart of khmer_tpu/ops/hashing.py. The numpy half (codec, scalar
hashes, host window hashes) is copied rather than imported, because
importing any ``khmer_tpu`` module imports JAX. Semantics (reference
include/oxli/kmer_hash.hh:62-96, src/oxli/kmer_hash.cc:65-208):

- 2-bit codec A=0, T=1, C=2, G=3; complement = code ^ 1;
- the forward hash packs MSB-first, the reverse hash packs the
  complement LSB-first; canonical = unsigned min(f, r);
- MurmurHash3_x64_128 (seed 0, h1) of the ASCII k-mer and of its
  reverse complement; canonical = h ^ r, or h for a palindrome.

The batched hashes run on int64 tensors holding u64 bit patterns
(ops/u64.py).
"""

import numpy as np
import torch

from khmer_tpu_torch.ops.u64 import srl, to_signed, umin

KSIZE_MAX = 32  # reference: include/oxli/oxli.hh:116
U64_MAX = 0xFFFFFFFFFFFFFFFF

_CODE = {"A": 0, "T": 1, "C": 2, "G": 3}
_CHAR = "ATCG"
_CHAR_ASCII = np.frombuffer(b"ATCG", dtype=np.uint8)

# ASCII -> 2-bit code with cleaning: acgt -> upper, everything else -> A.
# (reference _to_valid_dna: src/oxli/read_parsers.cc:53-69)
ASCII_TO_CODE = np.zeros(256, dtype=np.uint8)
for _c, _v in _CODE.items():
    ASCII_TO_CODE[ord(_c)] = _v
    ASCII_TO_CODE[ord(_c.lower())] = _v


def encode_dna(seq):
    """ASCII bytes/str -> cleaned 2-bit codes (uint8 numpy array)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    return ASCII_TO_CODE[arr]


# IUPAC-aware reverse complement table (reference: src/oxli/kmer_hash.cc:53-56)
_RC_TBL = (
    "                                                                "
    " TVGH FCD  M KN   YSAABW R       TVGH FCD  M KN   YSAABW R"
)
RC_ASCII = np.zeros(256, dtype=np.uint8)
for _i in range(256):
    RC_ASCII[_i] = ord(_RC_TBL[_i]) if _i < len(_RC_TBL) else 0


def reverse_complement(seq: str) -> str:
    """IUPAC-aware reverse complement, matching oxli::_revcomp."""
    arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return RC_ASCII[arr[::-1]].tobytes().decode()


def _hash_scalar(kmer: str, k: int):
    """Return (canonical, f, r) for the reversible 2-bit hash."""
    if k > KSIZE_MAX:
        raise ValueError("k-mer size must be <= %d" % KSIZE_MAX)
    if len(kmer) < k:
        raise ValueError("k-mer is too short to hash.")
    h = 0
    r = 0
    for i in range(k):
        h = (h << 2) | _CODE.get(kmer[i], 3)  # non-ACGT: C++ maps to G (3)
        r = (r << 2) | (_CODE.get(kmer[k - 1 - i], 3) ^ 1)
    return min(h, r), h, r


def reverse_hash(hashval: int, ksize: int) -> str:
    """Invert the forward 2-bit hash back into a k-mer string."""
    if ksize > KSIZE_MAX:
        raise ValueError("k-mer size must be <= %d" % KSIZE_MAX)
    s = []
    for _ in range(ksize):
        s.append(_CHAR[hashval & 3])
        hashval >>= 2
    return "".join(reversed(s))


def _murmur3_x64_128(data: bytes, seed: int = 0):
    """Pure-Python MurmurHash3_x64_128 -> (h1, h2). Oracle for the
    batched versions."""
    M = U64_MAX
    c1 = 0x87C37B91114253D5
    c2 = 0x4CF5AD432745937F
    length = len(data)
    h1 = h2 = seed
    nblocks = length // 16

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    def fmix(kk):
        kk ^= kk >> 33
        kk = (kk * 0xFF51AFD7ED558CCD) & M
        kk ^= kk >> 33
        kk = (kk * 0xC4CEB9FE1A85EC53) & M
        kk ^= kk >> 33
        return kk

    for b in range(nblocks):
        k1 = int.from_bytes(data[b * 16:b * 16 + 8], "little")
        k2 = int.from_bytes(data[b * 16 + 8:b * 16 + 16], "little")
        k1 = (k1 * c1) & M
        k1 = rotl(k1, 31)
        k1 = (k1 * c2) & M
        h1 ^= k1
        h1 = rotl(h1, 27)
        h1 = (h1 + h2) & M
        h1 = (h1 * 5 + 0x52DCE729) & M
        k2 = (k2 * c2) & M
        k2 = rotl(k2, 33)
        k2 = (k2 * c1) & M
        h2 ^= k2
        h2 = rotl(h2, 31)
        h2 = (h2 + h1) & M
        h2 = (h2 * 5 + 0x38495AB5) & M

    tail = data[nblocks * 16:]
    k1 = k2 = 0
    if len(tail) > 8:
        k2 = int.from_bytes(tail[8:].ljust(8, b"\0"), "little")
        k2 = (k2 * c2) & M
        k2 = rotl(k2, 33)
        k2 = (k2 * c1) & M
        h2 ^= k2
    if len(tail) > 0:
        k1 = int.from_bytes(tail[:8].ljust(8, b"\0"), "little")
        k1 = (k1 * c1) & M
        k1 = rotl(k1, 31)
        k1 = (k1 * c2) & M
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & M
    h2 = (h2 + h1) & M
    h1 = fmix(h1)
    h2 = fmix(h2)
    h1 = (h1 + h2) & M
    h2 = (h2 + h1) & M
    return h1, h2


def _hash_murmur_scalar(kmer: str):
    """Return (canonical, h, r) for the murmur hash of a k-mer string."""
    h = _murmur3_x64_128(kmer.encode("ascii"))[0]
    rev = reverse_complement(kmer)
    if rev == kmer:
        return h, h, h
    r = _murmur3_x64_128(rev.encode("ascii"))[0]
    return h ^ r, h, r


def hash_murmur3(kmer: str) -> int:
    """Canonical murmur hash (h ^ r, or h for palindromes)."""
    return _hash_murmur_scalar(kmer)[0]


def hash_no_rc_murmur3(kmer: str) -> int:
    """Forward-strand-only murmur hash."""
    return _murmur3_x64_128(kmer.encode("ascii"))[0]


def host_hash_windows(codes, k):
    """Canonical 2-bit window hashes on the host (numpy uint64).

    Window i packs codes[i..i+k-1] forward and complement-reversed, with
    k shifted vector ORs."""
    codes = np.asarray(codes, dtype=np.uint64)
    W = codes.shape[0] - k + 1
    if W <= 0:
        return np.zeros(0, dtype=np.uint64)
    f = np.zeros(W, dtype=np.uint64)
    r = np.zeros(W, dtype=np.uint64)
    for j in range(k):
        f |= codes[j:j + W] << np.uint64(2 * (k - 1 - j))
        r |= (codes[j:j + W] ^ np.uint64(1)) << np.uint64(2 * j)
    return np.minimum(f, r)


def host_murmur_hash_windows(codes, k):
    """Canonical murmur window hashes on the host (numpy uint64).

    The word packing and MurmurHash3_x64_128 of murmur_hash_windows, in
    numpy u64 (wrapping) arithmetic; bit-identical to
    _hash_murmur_scalar for k <= 64 (see murmur_hash_windows)."""
    codes = np.asarray(codes, dtype=np.uint8)
    W = codes.shape[0] - k + 1
    if W <= 0:
        return np.zeros(0, dtype=np.uint64)
    chars_f = _CHAR_ASCII[codes].astype(np.uint64)
    chars_r = _CHAR_ASCII[codes ^ 1].astype(np.uint64)
    nwords = (k + 7) // 8

    def words(chars, rc):
        out = []
        for m in range(nwords):
            w = np.zeros(W, dtype=np.uint64)
            for b in range(8):
                t = m * 8 + b
                if t >= k:
                    break
                pos = (k - 1 - t) if rc else t
                w |= chars[pos:pos + W] << np.uint64(8 * b)
            out.append(w)
        return out

    def murmur(ws):
        c1 = np.uint64(0x87C37B91114253D5)
        c2 = np.uint64(0x4CF5AD432745937F)
        h1 = np.zeros(W, dtype=np.uint64)
        h2 = np.zeros(W, dtype=np.uint64)

        def rotl(x, r):
            return (x << np.uint64(r)) | (x >> np.uint64(64 - r))

        def fmix(kk):
            kk = kk ^ (kk >> np.uint64(33))
            kk = kk * np.uint64(0xFF51AFD7ED558CCD)
            kk = kk ^ (kk >> np.uint64(33))
            kk = kk * np.uint64(0xC4CEB9FE1A85EC53)
            return kk ^ (kk >> np.uint64(33))

        nblocks = k // 16
        for b in range(nblocks):
            k1 = ws[2 * b] * c1
            k1 = rotl(k1, 31) * c2
            h1 = h1 ^ k1
            h1 = rotl(h1, 27) + h2
            h1 = h1 * np.uint64(5) + np.uint64(0x52DCE729)
            k2 = ws[2 * b + 1] * c2
            k2 = rotl(k2, 33) * c1
            h2 = h2 ^ k2
            h2 = rotl(h2, 31) + h1
            h2 = h2 * np.uint64(5) + np.uint64(0x38495AB5)
        taillen = k % 16
        if taillen > 8:
            k2 = ws[2 * nblocks + 1] * c2
            h2 = h2 ^ (rotl(k2, 33) * c1)
        if taillen > 0:
            k1 = ws[2 * nblocks] * c1
            h1 = h1 ^ (rotl(k1, 31) * c2)
        h1 = h1 ^ np.uint64(k)
        h2 = h2 ^ np.uint64(k)
        h1 = h1 + h2
        h2 = h2 + h1
        h1 = fmix(h1)
        h2 = fmix(h2)
        return h1 + h2

    with np.errstate(over="ignore"):
        h = murmur(words(chars_f, rc=False))
        r = murmur(words(chars_r, rc=True))
    # palindrome <=> 2-bit forward == 2-bit reverse encoding
    c64 = codes.astype(np.uint64)
    f2 = np.zeros(W, dtype=np.uint64)
    r2 = np.zeros(W, dtype=np.uint64)
    for j in range(k):
        if k - 1 - j < 32:
            f2 |= c64[j:j + W] << np.uint64(2 * (k - 1 - j))
        if j < 32:
            r2 |= (c64[j:j + W] ^ np.uint64(1)) << np.uint64(2 * j)
    return np.where(f2 == r2, h, h ^ r)


def rolling_hash_windows(codes, k: int):
    """(canonical, f, r) 2-bit hashes of every k-window.

    codes: [..., L] uint8 2-bit codes. Returns three [..., L-k+1] int64
    tensors of u64 bit patterns. For k = 32 the shifts wrap through the
    sign bit, and the canonical minimum is taken unsigned.
    """
    L = codes.shape[-1]
    W = L - k + 1
    if W <= 0:
        raise ValueError("sequence shorter than k")
    c = codes.to(torch.int64)
    f = torch.zeros(codes.shape[:-1] + (W,), dtype=torch.int64,
                    device=codes.device)
    r = torch.zeros_like(f)
    for j in range(k):
        f = (f << 2) | c[..., j:j + W]
        r = (r << 2) | (c[..., k - 1 - j:k - 1 - j + W] ^ 1)
    return umin(f, r), f, r


_ASCII_OF_CODE = torch.tensor([ord(c) for c in _CHAR], dtype=torch.int64)
_C1 = to_signed(0x87C37B91114253D5)
_C2 = to_signed(0x4CF5AD432745937F)
_F1 = to_signed(0xFF51AFD7ED558CCD)
_F2 = to_signed(0xC4CEB9FE1A85EC53)


def _rotl(x, r):
    return (x << r) | srl(x, 64 - r)


def _fmix(x):
    x = x ^ srl(x, 33)
    x = x * _F1
    x = x ^ srl(x, 33)
    x = x * _F2
    return x ^ srl(x, 33)


def _window_bytes_words(codes, k: int, rc: bool):
    """Each k-window's ASCII bytes (of its reverse complement with rc),
    packed little-endian into ceil(k/8) int64 words of u64 bits:
    [..., L] uint8 codes -> a list of [..., L-k+1] tensors."""
    W = codes.shape[-1] - k + 1
    c = codes.to(torch.int64)
    chars = _ASCII_OF_CODE.to(codes.device)[c ^ 1 if rc else c]
    words = []
    for m in range((k + 7) // 8):
        w = torch.zeros(codes.shape[:-1] + (W,), dtype=torch.int64,
                        device=codes.device)
        for b in range(min(8, k - 8 * m)):
            t = 8 * m + b  # byte t of the k-mer
            pos = (k - 1 - t) if rc else t
            w = w | (chars[..., pos:pos + W] << (8 * b))
        words.append(w)
    return words


def _murmur3_x64_128_words(words, length: int):
    """MurmurHash3_x64_128 (seed 0) of `length` bytes packed in
    ceil(length/8) int64 words (zero past `length`); returns h1. The
    int64 products and sums wrap to the u64 bits."""
    h1 = torch.zeros_like(words[0])
    h2 = torch.zeros_like(words[0])
    nblocks = length // 16
    for b in range(nblocks):
        k1 = _rotl(words[2 * b] * _C1, 31) * _C2
        h1 = _rotl(h1 ^ k1, 27) + h2
        h1 = h1 * 5 + 0x52DCE729
        k2 = _rotl(words[2 * b + 1] * _C2, 33) * _C1
        h2 = _rotl(h2 ^ k2, 31) + h1
        h2 = h2 * 5 + 0x38495AB5
    taillen = length % 16
    if taillen > 8:
        h2 = h2 ^ (_rotl(words[2 * nblocks + 1] * _C2, 33) * _C1)
    if taillen > 0:
        h1 = h1 ^ (_rotl(words[2 * nblocks] * _C1, 31) * _C2)
    h1 = h1 ^ length
    h2 = h2 ^ length
    h1 = h1 + h2
    h2 = h2 + h1
    return _fmix(h1) + _fmix(h2)


def murmur_hash_windows(codes, k: int):
    """(canonical, h, r) murmur hashes of every k-window, [..., L-k+1]
    int64 tensors of u64 bits: h of the window's ASCII bytes, r of its
    reverse complement's, canonical h ^ r, or h for a palindrome.

    As JAX's murmur_hash_windows, a window is a palindrome when its 2-bit
    forward and reverse words (the 64-bit words of rolling_hash_windows,
    which keep the last 32 codes) are equal: for k <= 64 exactly when the
    window equals its reverse complement; for k > 64 also for some
    windows that do not (the native host hash, JAX's `auto` engine, tests
    the whole window)."""
    h = _murmur3_x64_128_words(_window_bytes_words(codes, k, False), k)
    r = _murmur3_x64_128_words(_window_bytes_words(codes, k, True), k)
    _, f2, r2 = rolling_hash_windows(codes, k)
    return torch.where(f2 == r2, h, h ^ r), h, r


def hash_windows(codes, k: int, hash_family: str):
    """Canonical hashes of every k-window for the given hash family: the
    [..., L-k+1] int64 tensor of u64 bit patterns."""
    if hash_family == "twobit":
        return rolling_hash_windows(codes, k)[0]
    elif hash_family == "murmur":
        return murmur_hash_windows(codes, k)[0]
    else:
        raise ValueError("unknown hash family %r" % hash_family)


U64_MAX = 0xFFFFFFFFFFFFFFFF


def compute_band_interval(num_bands: int, band: int):
    """[lo, hi) of band `band` when the u64 hash space is split into
    `num_bands` equal bands (Python ints; the top band stops below
    U64_MAX, whose remainder no band holds). Mirrors
    oxli::compute_band_interval (src/oxli/kmer_hash.cc:261-275)."""
    if band >= num_bands:
        raise ValueError(
            "'band' must be in the interval [0, 'num_bands')"
            ", %d not in [0, %d)" % (band, num_bands))
    band_size = U64_MAX // num_bands
    return band_size * band, band_size * (band + 1)
