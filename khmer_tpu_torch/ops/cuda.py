"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
Hopper (sm_90a), all started together, and the objects are linked into
one shared library with a plain C interface, loaded with ctypes. The
build runs at first use, into ``khmer_tpu_torch/_build/`` (not
committed), and again whenever a source is newer than the library.
Each C entry point launches on the stream it is given, allocates
nothing and returns ``cudaGetLastError()``; ``check`` turns a non-zero
code into an exception. The one exception is a walk's probe context
(csrc/neighbors.cu ``khmer_probe_ctx_new``), which owns grow-only pinned
and device blocks for the walk's levels.
"""

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libkhmer_tpu_torch_kernels.so")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v", "-c"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int

# name -> argtypes of each C entry point (restype int: cudaError_t)
_ENTRY_POINTS = {
    # table, nblocks, hashes, m, nvalid, nbuckets, ids, start, cursor,
    # ev_word, flags, n_unique, device, stream
    "khmer_blocked_update": [_P, _I64, _P, _I64, _I64, _I32, _P, _P, _P,
                             _P, _P, _P, _I32, _P],
    # table, nblocks, hashes, n, out, device, stream
    "khmer_blocked_gather": [_P, _I64, _P, _I64, _P, _I32, _P],
    # flat, size, ntables, primes (host), offsets (host), hashes, nvalid,
    # nbuckets, ids, start, cursor, ev_word, min_old, n_unique,
    # cand_hash, cand_old, n_cand, flags, device, stream
    "khmer_byte_update": [_P, _I64, _I32, _P, _P, _P, _I64, _I32, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P, _P, _I32, _P],
    # flat, ntables, primes (host), offsets (host), hashes, n, out,
    # device, stream
    "khmer_byte_gather": [_P, _I32, _P, _P, _P, _I64, _P, _I32, _P],
    # flat, ntables, primes (host), offsets (host), hashes, n, out [T, n],
    # device, stream
    "khmer_byte_pertable": [_P, _I32, _P, _P, _P, _I64, _P, _I32, _P],
    # flat, size, ntables, primes (host), nibble offsets (host), hashes,
    # nvalid, nbuckets, max_tiles, recs, counts, start, offsets, flags,
    # n_unique, device, stream
    "khmer_nibble_update": [_P, _I64, _I32, _P, _P, _P, _I64, _I32, _I64,
                            _P, _P, _P, _P, _P, _P, _I32, _P],
    # flat, ntables, primes (host), nibble offsets (host), hashes, n, mask
    # (or null), out, device, stream
    "khmer_nibble_gather": [_P, _I32, _P, _P, _P, _I64, _P, _P, _I32, _P],
    # flat, ntables, primes (host), nibble offsets (host), hashes, n,
    # out [T, n], device, stream
    "khmer_nibble_pertable": [_P, _I32, _P, _P, _P, _I64, _P, _I32, _P],
    # flat, ntables, primes (host), nibble offsets (host), codes, lengths,
    # nrows, L, k, rows, seg, hashes, counters, index, device, stream
    "khmer_nibble_pertable_rows": [_P, _I32, _P, _P, _P, _P, _I64, _I32,
                                   _I32, _I32, _I32, _P, _P, _P, _I32, _P],
    # flat, ntables, primes (host), nibble offsets (host), codes, lengths,
    # nrows, L, k, rows, seg, counts, device, stream
    "khmer_nibble_row_counts": [_P, _I32, _P, _P, _P, _P, _I64, _I32, _I32,
                                _I32, _I32, _P, _I32, _P],
    # idx, n, out, nbins, blocks, device, stream
    "khmer_histogram_add": [_P, _I64, _P, _I64, _I32, _I32, _P],
    # bids, offs, m, table, nblocks, nbuckets, ids, start, cursor,
    # ev_word, nnew, device, stream
    "khmer_proto_rmw": [_P, _P, _I64, _P, _I64, _I32, _P, _P, _P, _P, _P,
                        _I32, _P],
    # flat, ntables, primes (host), offsets (host), codes, lengths,
    # nbundles, L, k, cutoff, rows, seg, bit_words, reject, loads, device,
    # stream
    "khmer_diginorm_med": [_P, _I32, _P, _P, _P, _P, _I64, _I32, _I32, _I32,
                           _I32, _I32, _I32, _P, _P, _I32, _P],
    # flat, ntables, primes (host), offsets (host), codes, lengths, reject,
    # nbundles, L, k, cutoff, sub, smem, hashes, keep, n_unique, n_cand,
    # n_groups, device, stream
    "khmer_diginorm_scan": [_P, _I32, _P, _P, _P, _P, _P, _I64, _I32, _I32,
                            _I32, _I32, _I32, _P, _P, _P, _P, _P, _I32, _P],
    # flat, ntables, primes (host), offsets (host), codes, lengths,
    # nbundles, L, k, cutoff, trim_cov, digi_cov, use_digi, bits, marks,
    # state, branch, trim_at, n_cand, device, stream
    "khmer_trim_mark": [_P, _I32, _P, _P, _P, _P, _I64, _I32, _I32, _I32,
                        _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P, _I32,
                        _P],
    # flat, ntables, primes (host), offsets (host), codes, lengths,
    # nbundles, L, k, cutoff, digi_cov, bits, marks, state, device, stream
    "khmer_trim_probe": [_P, _I32, _P, _P, _P, _P, _I64, _I32, _I32, _I32,
                         _I32, _I32, _P, _P, _I32, _P],
    # flat, ntables, primes (host), offsets (host), codes, lengths, state,
    # nbundles, L, k, cutoff, trim_cov, digi_cov, use_digi, sub, smem,
    # branch, trim_at, n_unique, n_live, n_groups, device, stream
    "khmer_trim_scan": [_P, _I32, _P, _P, _P, _P, _P, _I64, _I32, _I32,
                        _I32, _I32, _I32, _I32, _I32, _I32, _P, _P, _P, _P,
                        _P, _I32, _P],
    # flat, ntables, primes (host), offsets (host), codes, lengths, nrows,
    # L, k, cutoff, at_least, rows, seg, big_keys, big_values, nbig,
    # trim_at, n_ge, scratch, counts, device, stream
    "khmer_read_counts": [_P, _I32, _P, _P, _P, _P, _I64, _I32, _I32, _I32,
                          _I32, _I32, _I32, _P, _P, _I64, _P, _P, _P, _P,
                          _I32, _P],
    # flat, size, ntables, primes (host), bit offsets (host), hashes,
    # valid, m_total, nvalid, nbuckets, ids, start, cursor, ev_word, mask,
    # flags, n_unique, device, stream
    "khmer_bit_update": [_P, _I64, _I32, _P, _P, _P, _P, _I64, _I64, _I32,
                         _P, _P, _P, _P, _P, _P, _P, _I32, _P],
    # codes, fill, starts, nstarts, k, p, registers, blocks, device, stream
    "khmer_hll_add": [_P, _I64, _P, _I64, _I32, _I32, _P, _I32, _I32, _P],
    # flat, ntables, primes (host), bit offsets (host), f, r, n, k, out,
    # device, stream
    "khmer_neighbors": [_P, _I32, _P, _P, _P, _P, _I64, _I32, _P, _I32, _P],
    # flat, ntables, primes (host), bit offsets (host), hashes, n, out,
    # device, stream
    "khmer_bit_gather": [_P, _I32, _P, _P, _P, _I64, _P, _I32, _P],
    # flat, ntables, primes (host), offsets (host), f, r, n, k, lo, hi,
    # big_keys, big_values, nbig, out, band_out, small, device, stream
    "khmer_byte_neighbors": [_P, _I32, _P, _P, _P, _P, _I64, _I32, _I32,
                             _I32, _P, _P, _I64, _P, _P, _I32, _I32, _P],
    # hashes, n, nvalid, band, lo, hi, counts, threshold, at_least, out,
    # count, totals, device, stream
    "khmer_consume_filter": [_P, _I64, _I64, _I32, _I64, _I64, _P, _I32,
                             _I32, _P, _P, _P, _I32, _P],
    # flat, ntables, primes (host), nibble offsets (host), f, r, n, k, lo,
    # hi, out, band_out, small, device, stream
    "khmer_nibble_neighbors": [_P, _I32, _P, _P, _P, _P, _I64, _I32, _I32,
                               _I32, _P, _P, _I32, _I32, _P],
    # ctx, frontier (host), n, masks (host), band (host)
    "khmer_byte_probe_level": [_P, _P, _I64, _P, _P],
    "khmer_nibble_probe_level": [_P, _P, _I64, _P, _P],
    "khmer_bit_probe_level": [_P, _P, _I64, _P, _P],
}

# name -> (argtypes, restype) of the entry points that return no error
# code: a walk's probe context (csrc/neighbors.cu)
_CONTEXT_POINTS = {
    # flat, ntables, primes (host), offsets (host), kind (0 byte, 1 bit,
    # 2 nibble), k, band, lo, hi,
    # big_keys, big_values, nbig, small_below, device, stream
    "khmer_probe_ctx_new": ([_P, _I32, _P, _P, _I32, _I32, _I32, _I32, _I32,
                             _P, _P, _I64, _I64, _I32, _P], _P),
    "khmer_probe_ctx_free": ([_P], None),
    # ctx, n -> a pinned block (csrc/level_block.h)
    "khmer_probe_block": ([_P, _I64], _P),
    # ctx, out (6 doubles)
    "khmer_probe_ctx_stats": ([_P, _P], None),
}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh"))
                  + [os.path.join(CSRC, "level_block.h")])


def _stale():
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in _sources())


def build():
    """Compile csrc/*.cu into LIB_PATH when it is missing or stale: one
    nvcc per source, all at once, then one link.

    Returns (seconds spent, nvcc's report: ptxas registers and shared
    memory per kernel); (0.0, "") when the library was current.
    """
    if not _stale():
        return 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = "%d.tmp" % os.getpid()
    units = [(src, os.path.join(BUILD_DIR, "%s.%s.o" % (
        os.path.basename(src), tag)))
        for src in _sources() if src.endswith(".cu")]
    t0 = time.perf_counter()
    procs = [(subprocess.Popen(
        [_nvcc()] + COMPILE_FLAGS + ["-o", obj, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        src) for src, obj in units]
    report = []
    failed = []
    for proc, src in procs:
        _, err = proc.communicate()
        report.append(err)
        if proc.returncode != 0:
            failed.append("%s (%d):\n%s" % (src, proc.returncode, err))
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    tmp = "%s.%s" % (LIB_PATH, tag)
    cmd = ([_nvcc()] + ARCH_FLAGS + ["-shared", "-o", tmp]
           + [obj for _, obj in units])
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc link failed (%d):\n%s\n%s" % (
            proc.returncode, " ".join(cmd), proc.stderr))
    for _, obj in units:
        os.remove(obj)
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0, "".join(report)


@functools.cache
def library():
    """The loaded kernel library (built on first use)."""
    build()
    lib = ctypes.CDLL(LIB_PATH)
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, (argtypes, restype) in _CONTEXT_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.khmer_cuda_error_string.argtypes = [ctypes.c_int]
    lib.khmer_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err, name):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().khmer_cuda_error_string(err).decode()
        raise RuntimeError("%s: CUDA error %d (%s)" % (name, err, msg))
