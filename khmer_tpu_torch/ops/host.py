"""Build and load the port's C++ host library (csrc/*.cc).

The tag-spacing pass of load-graph's tagged consume and its tag set
(csrc/tag_spacing.cc) run on the host: the pass is sequential over the
whole stream. The library is compiled with g++ at first use into
``khmer_tpu_torch/_build/`` (not committed), and again whenever a source
is newer than it. A failed build raises; nothing falls back to Python.
"""

import ctypes
import functools
import glob
import os
import subprocess

import numpy as np

from khmer_tpu_torch.ops.cuda import BUILD_DIR, CSRC

LIB_PATH = os.path.join(BUILD_DIR, "libkhmer_tpu_torch_host.so")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cc")))


def build():
    """Compile csrc/*.cc into LIB_PATH when it is missing or stale."""
    if os.path.exists(LIB_PATH) and all(
            os.path.getmtime(s) <= os.path.getmtime(LIB_PATH)
            for s in _sources()):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (LIB_PATH, os.getpid())
    cmd = (["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp]
           + _sources())
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("g++ failed (%d):\n%s\n%s" % (
            proc.returncode, " ".join(cmd), proc.stderr))
    os.replace(tmp, LIB_PATH)


@functools.cache
def library():
    """The loaded host library (built on first use)."""
    build()
    lib = ctypes.CDLL(LIB_PATH)
    for name, args, res in (
            ("kt_set_new", [_I64], _P),
            ("kt_set_free", [_P], None),
            ("kt_set_add", [_P, _P, _I64], None),
            ("kt_set_size", [_P], _I64),
            ("kt_set_export", [_P, _P], None),
            ("kt_tag_spacing", [_P, _P, _P, _P, _I64, ctypes.c_int, _P],
             _I64),
            ("kt_tag_spacing_end", [_P, ctypes.c_int, _P], None)):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def _u64(values):
    return np.ascontiguousarray(values, dtype=np.uint64)


class TagSpacing:
    """A tag set and the spacing state of one tagged consume
    (csrc/tag_spacing.cc): feed it each chunk's k-mers in stream order,
    then end() it and read its tags."""

    def __init__(self, tags, density):
        self._lib = library()
        self._density = int(density)
        tags = _u64(sorted(tags))
        self._set = self._lib.kt_set_new(max(64, len(tags)))
        self._lib.kt_set_add(self._set, tags.ctypes.data, len(tags))
        # since, last k-mer, whether a read is open
        self._state = np.array([self._density // 2 + 1, 0, 0], np.int64)

    def step(self, hashes, is_new, read_start):
        """The pass over one chunk: u64 hashes, their new flags and read
        starts (one byte each). Returns its new k-mers."""
        hashes = _u64(hashes)
        is_new = np.ascontiguousarray(is_new, dtype=np.uint8)
        read_start = np.ascontiguousarray(read_start, dtype=np.uint8)
        n = len(hashes)
        if len(is_new) != n or len(read_start) != n:
            raise ValueError("hashes, is_new and read_start differ in length")
        return int(self._lib.kt_tag_spacing(
            self._set, hashes.ctypes.data, is_new.ctypes.data,
            read_start.ctypes.data, n, self._density,
            self._state.ctypes.data))

    def end(self):
        """Close the stream's last read; returns the tags as a set."""
        self._lib.kt_tag_spacing_end(self._set, self._density,
                                     self._state.ctypes.data)
        out = np.empty(int(self._lib.kt_set_size(self._set)), np.uint64)
        self._lib.kt_set_export(self._set, out.ctypes.data)
        return set(int(t) for t in out)

    def close(self):
        if getattr(self, "_set", None):
            self._lib.kt_set_free(self._set)
            self._set = None

    __del__ = close
