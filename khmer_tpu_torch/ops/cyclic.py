"""Cyclic (rolling) hash — a copy of khmer_tpu/ops/cyclic.py (which
imports no JAX, but importing it would run khmer_tpu/__init__.py, which
does), mirroring the third-party CyclicHash used by oxli::_hash_cyclic
(src/oxli/kmer_hash.cc:210-258):

    eat(c):  h = rotl64(h, 1) ^ table[c]
    canonical = fwd + revcomp (mod 2^64)

wordsize is 64 (third-party/rollinghash/cyclichash.h:129), and the
per-character 64-bit constants are the fixed table from
characterhash.h (loaded from a copy of the JAX package's data file,
khmer_tpu_torch/core/data/cyclic_table.npz).
"""

import os

import numpy as np

U64 = 0xFFFFFFFFFFFFFFFF

_TABLE = None


def _table():
    global _TABLE
    if _TABLE is None:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "core", "data",
            "cyclic_table.npz")
        _TABLE = np.load(path)["table"]
    return _TABLE


def _rotl1(x):
    return ((x << 1) | (x >> 63)) & U64


def _cyclic_hash_str(s):
    table = _table()
    h = 0
    for ch in s:
        h = _rotl1(h) ^ int(table[ord(ch)])
    return h


def hash_cyclic(kmer, k):
    """oxli::_hash_cyclic canonical = fwd + revcomp (mod 2^64)."""
    from khmer_tpu_torch.ops.hashing import reverse_complement

    h = _cyclic_hash_str(kmer)
    r = _cyclic_hash_str(reverse_complement(kmer))
    return (h + r) & U64


def hash_cyclic_forward(kmer, k):
    return _cyclic_hash_str(kmer)


_COMP = bytes.maketrans(b"ACGTacgt", b"TGCATGCA")


def _rotl(x, a):
    a &= 63
    if a == 0:
        return x
    return ((x << np.uint64(a)) | (x >> np.uint64(64 - a)))


def hash_cyclic_windows(seq, k):
    """Canonical cyclic hashes for all k-windows, vectorized.

    The cyclic hash unrolls to a closed form — window i is the XOR of
    per-character constants rotated by their distance from the window
    end:  h(i) = XOR_{j<k} rotl(t[s[i+j]], k-1-j)  — so the whole
    sequence hashes with k shifted vector XORs instead of a Python
    loop per window.  Canonical = fwd + revcomp hash (mod 2^64),
    matching oxli::_hash_cyclic (kmer_hash.cc:210-258).
    """
    n = len(seq)
    W = n - k + 1
    if W <= 0:
        return np.zeros(0, dtype=np.uint64)
    table = _table().astype(np.uint64)
    b = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    tv = table[b]                                  # t[s[p]]
    tv_c = table[np.frombuffer(seq.encode("ascii").translate(_COMP),
                               dtype=np.uint8)]    # t[comp(s[p])]
    h = np.zeros(W, dtype=np.uint64)
    r = np.zeros(W, dtype=np.uint64)
    for j in range(k):
        h ^= _rotl(tv[j:j + W], k - 1 - j)
        # revcomp window hash: rc(i) = XOR_u rotl(t[comp(s[i+u])], u)
        r ^= _rotl(tv_c[j:j + W], j)
    return h + r  # uint64 addition wraps mod 2^64 like the reference
