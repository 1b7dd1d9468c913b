"""The dense k-mer hasher of the host side (csrc/dense_hash.cc).

Counterpart of khmer_tpu/core/hostengine.py, binding only its two dense
hash entry points, those of the counting and tagging paths, copied into
the port's own C++ (2-bit family only) and built with the rest of it by
ops/host.py. A failed build raises.
"""

import numpy as np

from khmer_tpu_torch.ops import host


def _check_family(hash_family):
    if hash_family != "twobit":
        raise NotImplementedError("the %s hash is not yet ported"
                                  % hash_family)


def hash_dense(codes, starts, nfill, k, hash_family):
    """Dense canonical window hashes of a FlatPacker chunk, in stream
    order.

    `starts` are the ascending read-start offsets (int32, pad entries
    >= nfill ignored); boundary-spanning windows are skipped, so the
    result has one hash per real k-mer.
    """
    _check_family(hash_family)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    out = np.empty(max(int(nfill), 1), dtype=np.uint64)
    n = host.library().kt_hash_dense(
        codes.ctypes.data, int(nfill), starts.ctypes.data, len(starts),
        int(k), out.ctypes.data)
    return out[:n]


def hash_dense_reads(codes, offs, lens, k, hash_family):
    """Dense canonical hashes for a native-parser block, in read order
    (one C call per block)."""
    _check_family(hash_family)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.empty(max(int(lens.sum()), 1), dtype=np.uint64)
    n = host.library().kt_hash_dense_reads(
        codes.ctypes.data, offs.ctypes.data, lens.ctypes.data, len(lens),
        int(k), out.ctypes.data)
    return out[:n]
