"""The dense k-mer hasher of the host side (csrc/dense_hash.cc).

Counterpart of khmer_tpu/core/hostengine.py, binding only its two dense
hash entry points, those of the counting and tagging paths, copied into
the port's own C++ with both of their hash families (the 2-bit rolling
hash of the graphs, the murmur hash of the tables) and built with the
rest of it by ops/host.py. A failed build raises.
"""

import numpy as np

from khmer_tpu_torch.ops import host

# the C entry points' family argument
FAMILIES = {"twobit": 0, "murmur": 1}


def _family(hash_family):
    if hash_family not in FAMILIES:
        raise NotImplementedError("the dense host hash has no %s family"
                                  % hash_family)
    return FAMILIES[hash_family]


def hash_dense(codes, starts, nfill, k, hash_family):
    """Dense canonical window hashes of a FlatPacker chunk, in stream
    order.

    `starts` are the ascending read-start offsets (int32, pad entries
    >= nfill ignored); boundary-spanning windows are skipped, so the
    result has one hash per real k-mer.
    """
    family = _family(hash_family)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    out = np.empty(max(int(nfill), 1), dtype=np.uint64)
    n = host.library().kt_hash_dense(
        codes.ctypes.data, int(nfill), starts.ctypes.data, len(starts),
        int(k), family, out.ctypes.data)
    return out[:n]


def hash_dense_reads(codes, offs, lens, k, hash_family):
    """Dense canonical hashes for a native-parser block, in read order
    (one C call per block)."""
    family = _family(hash_family)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.empty(max(int(lens.sum()), 1), dtype=np.uint64)
    n = host.library().kt_hash_dense_reads(
        codes.ctypes.data, offs.ctypes.data, lens.ctypes.data, len(lens),
        int(k), family, out.ctypes.data)
    return out[:n]
