"""K-mer hashing: the 2-bit codec and reversible hash.

Counterpart of khmer_tpu/ops/hashing.py. The numpy half (codec, scalar
hash, host window hash) is copied rather than imported, because
importing any ``khmer_tpu`` module imports JAX. Semantics (reference
include/oxli/kmer_hash.hh:62-96, src/oxli/kmer_hash.cc:65-150):

- 2-bit codec A=0, T=1, C=2, G=3; complement = code ^ 1;
- the forward hash packs MSB-first, the reverse hash packs the
  complement LSB-first; canonical = unsigned min(f, r).

The batched rolling hash runs on int64 tensors holding u64 bit patterns
(ops/u64.py).
"""

import numpy as np
import torch

from khmer_tpu_torch.ops.u64 import umin

KSIZE_MAX = 32  # reference: include/oxli/oxli.hh:116

_CODE = {"A": 0, "T": 1, "C": 2, "G": 3}

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


def hash_windows(codes, k: int, hash_family: str):
    """Canonical hashes of every k-window for the given hash family: the
    [..., L-k+1] int64 tensor of u64 bit patterns."""
    if hash_family == "twobit":
        return rolling_hash_windows(codes, k)[0]
    elif hash_family == "murmur":
        raise NotImplementedError("the murmur hash is not yet ported")
    else:
        raise ValueError("unknown hash family %r" % hash_family)
