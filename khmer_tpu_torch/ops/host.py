"""Build and load the port's C++ host library (csrc/*.cc).

What runs on the host runs in the port's own C++: the FASTA/FASTQ parser
and 2-bit packer (csrc/fastx_io.cc, bound in io/native.py), the dense
k-mer hasher (csrc/dense_hash.cc, core/hostengine.py), the tag-spacing
pass of load-graph's tagged consume with its tag set
(csrc/tag_spacing.cc: the pass is sequential over the whole stream), the
partition walk, a level of a batch of traversals a pass
(csrc/tag_walk.cc, TagWalk below), the perimeter sweep likewise
(csrc/sweep_walk.cc, SweepWalk), and the knot pipeline's excursions,
likewise, with their evaluation (csrc/excursion_walk.cc, ExcursionWalk);
a walk runs to its end in C++ against a probe of its levels
(csrc/level_walk.cc kt_level_run, _LevelWalk.run).
The library is compiled with g++ at first use into
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

CXX = "g++"

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cc")))


def build(lib_path=None):
    """Compile csrc/*.cc into `lib_path` (LIB_PATH), for the machine it
    runs on, when it is missing or older than a source or header; raises
    if g++ fails."""
    lib_path = lib_path or LIB_PATH
    deps = _sources() + glob.glob(os.path.join(CSRC, "*.h"))
    if os.path.exists(lib_path) and all(
            os.path.getmtime(s) <= os.path.getmtime(lib_path)
            for s in deps):
        return
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp = "%s.%d.tmp" % (lib_path, os.getpid())
    cmd = ([CXX, "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-pthread", "-o", tmp] + _sources())
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("g++ failed (%d):\n%s\n%s" % (
            proc.returncode, " ".join(cmd), proc.stderr))
    os.replace(tmp, lib_path)


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
            ("kt_set_first_member", [_P, _P, _P, _I64, _P], None),
            ("kt_tag_spacing", [_P, _P, _P, _P, _I64, _I32, _P],
             _I64),
            ("kt_tag_spacing_end", [_P, _I32, _P], None),
            ("fastq_pack", [_P, _I64, _P, _P, _I64, _P, _P], _I64),
            ("fasta_pack", [_P, _I64, _P, _P, _I64, _P, _P], _I64),
            ("kt_hash_dense", [_P, _I64, _P, _I64, _I32, _I32, _P], _I64),
            ("kt_hash_dense_reads", [_P, _P, _P, _I64, _I32, _I32, _P],
             _I64),
            ("kt_level_pass", [_P, _P], _I64),
            ("kt_level_frontier", [_P, _P], None),
            ("kt_level_run", [_P, _P, _P, _P], _I32),
            ("kt_level_keeper_bytes", [_P], _I64),
            ("kt_level_stats", [_P, _P], None),
            ("kt_level_free", [_P], None),
            ("kt_walk_new", [_P, _P, _I64, _I32, _P, _I64, _P, _I64, _I32,
                             _I32, _I32, _I32, _P], _P),
            ("kt_walk_counts", [_P, _P], None),
            ("kt_sweep_new", [_P, _P, _P, _I64, _I32, _P, _I64, _P, _I64,
                              _I64, _I32, _I32, _I32], _P),
            ("kt_sweep_counts", [_P, _P, _P], None),
            ("kt_sweep_tags", [_P, _P], None),
            ("kt_walk_tags", [_P, _P], None),
            ("kt_exc_new", [_P, _P, _I64, _I32, _P, _I64, _I32, _I64,
                            _I32], _P),
            ("kt_exc_counts", [_P, _P], None),
            ("kt_exc_keepers", [_P, _I64, _P], None),
            ("kt_exc_evaluate", [_P, _P, _I64, _P, _I32, _I64, _I64, _I32,
                                 _P, _P, _P, _P], None)):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def _u64(values):
    return np.ascontiguousarray(values, dtype=np.uint64)


class U64Set:
    """A set of u64 in the host library (csrc/u64_set.h)."""

    def __init__(self, values):
        self._lib = library()
        values = _u64(values)
        self.handle = self._lib.kt_set_new(max(64, len(values)))
        self._lib.kt_set_add(self.handle, values.ctypes.data, len(values))

    def values(self):
        """Its members, u64, in no order."""
        out = np.empty(int(self._lib.kt_set_size(self.handle)), np.uint64)
        self._lib.kt_set_export(self.handle, out.ctypes.data)
        return out

    def first_members(self, values, counts):
        """For each group of counts[i] consecutive `values`, the index of
        its first member of the set, -1 where none is (int64 [groups])."""
        values = _u64(values)
        counts = np.ascontiguousarray(counts, dtype=np.int64)
        if counts.sum() > len(values):
            raise ValueError("the groups hold more values than given")
        out = np.empty(len(counts), np.int64)
        self._lib.kt_set_first_member(self.handle, values.ctypes.data,
                                      counts.ctypes.data, len(counts),
                                      out.ctypes.data)
        return out

    def close(self):
        if getattr(self, "handle", None):
            self._lib.kt_set_free(self.handle)
            self.handle = None

    __del__ = close


class TagSpacing:
    """A tag set and the spacing state of one tagged consume
    (csrc/tag_spacing.cc): feed it each chunk's k-mers in stream order,
    then end() it and read its tags."""

    def __init__(self, tags, density):
        self._lib = library()
        self._density = int(density)
        self._tags = U64Set(sorted(tags))
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
            self._tags.handle, hashes.ctypes.data, is_new.ctypes.data,
            read_start.ctypes.data, n, self._density,
            self._state.ctypes.data))

    def end(self):
        """Close the stream's last read; returns the tags as a set."""
        self._lib.kt_tag_spacing_end(self._tags.handle, self._density,
                                     self._state.ctypes.data)
        return set(int(t) for t in self._tags.values())

    def close(self):
        self._tags.close()


def walk_threads():
    """Threads of a walk's pass: the host's cores, at most 16."""
    return max(1, min(16, os.cpu_count() or 1))


# A probe of a walk's levels (csrc/level_walk.cc): (ctx, the frontier: f of
# each of n nodes, then r (u64 [2 n]), n, the masks out (u8 [n]), the band
# bytes out (u8 [n]; null but in a banded walk)) -> 0, or a code that ends
# the walk.
PROBE_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p)

# kt_level_stats' fields
LEVEL_STATS = ("levels", "nodes", "walk_s", "frontier_s", "probe_s")


class ProbeError(RuntimeError):
    """A walk's probe failed: the walk stopped where it was and holds no
    answer. `code` is the probe's (a CUDA error on the card), or -1 where
    no block could be had for a level."""

    def __init__(self, code):
        super().__init__("the walk's probe failed with code %d; the walk "
                         "holds no answer" % code if code != -1 else
                         "no block could be had for a level of the walk")
        self.code = code


class _LevelWalk:
    """What TagWalk, SweepWalk and ExcursionWalk share (csrc/level_walk.h).
    run() walks every level to the end in C++, each frontier probed by a C
    function (the card's, csrc/neighbors.cu) or a PROBE_FN callback (the
    plain versions on the CPU). Or, a level at a time from Python: step()
    walks a level of every traversal and frontier() hands out the nodes to
    probe; the next step() takes their neighbour bytes (kernel L's byte a
    node) and walks their present children. An empty frontier ends the
    walk. A pass runs on walk_threads() threads."""

    _walk = None

    def run(self, probe, block=None, ctx=None):
        """Walk to the end (kt_level_run): `probe` (a C function's address,
        or a PROBE_FN) probes each level, `block` (a C function's address,
        or None: the walk's own storage) hands out each level's block
        (csrc/level_block.h), both with `ctx`. Raises ProbeError if the
        probe fails."""
        code = self._lib.kt_level_run(self._walk, probe, block, ctx)
        if code:
            raise ProbeError(code)

    def stats(self):
        """The walk's clocks so far (kt_level_stats): {levels, nodes, and
        host seconds walking the levels, writing the frontiers, in the
        probes}."""
        out = np.zeros(len(LEVEL_STATS))
        self._lib.kt_level_stats(self._walk, out.ctypes.data)
        return dict(zip(LEVEL_STATS, out.tolist()))

    def step(self, masks=None):
        """Walk a level: of the children that `masks` (uint8, a byte for
        each node of the last frontier) allows, or of the start k-mers on
        the first step. Returns the new frontier's length, 0 once the
        walk has ended."""
        if masks is not None:
            masks = np.ascontiguousarray(masks, dtype=np.uint8)
        return int(self._lib.kt_level_pass(
            self._walk, None if masks is None else masks.ctypes.data))

    def frontier(self, out):
        """Write the frontier's k-mers into `out`, a u64 buffer of at
        least twice its length (e.g. a view of pinned memory): f of each
        node, then r of each."""
        if out.dtype != np.uint64 or not out.flags.c_contiguous:
            raise ValueError("out must be a contiguous u64 array")
        self._lib.kt_level_frontier(self._walk, out.ctypes.data)

    def keeper_bytes(self):
        """The most host bytes the traversals held at the end of a pass so
        far."""
        return int(self._lib.kt_level_keeper_bytes(self._walk))

    def close(self):
        if self._walk:
            self._lib.kt_level_free(self._walk)
            self._walk = None

    __del__ = close


class TagWalk(_LevelWalk):
    """The partition walk of a batch of traversals (csrc/tag_walk.cc), a
    breadth level of each a pass. Start it from the k-mers (f, r) of the
    start tags, with the graph's tags and stop tags; once the walk has
    ended, tags() holds what each traversal found. start_ok (a bool a
    start, or None) makes it the abundance-truncated walk: whether each
    start is in the band; its probe then gives the band bytes of each
    frontier beside its neighbour bytes."""

    def __init__(self, start_f, start_r, k, tags, stop_tags, max_breadth,
                 break_on_stop_tags, stop_big_traversals, start_ok=None):
        self._lib = library()
        start_f, start_r = _u64(start_f), _u64(start_r)
        tags, stop_tags = _u64(tags), _u64(stop_tags)
        self.n = len(start_f)
        self.banded = start_ok is not None
        if self.banded:
            start_ok = np.ascontiguousarray(start_ok, dtype=np.uint8)
            if len(start_ok) != self.n:
                raise ValueError("start_ok holds %d starts, not %d"
                                 % (len(start_ok), self.n))
        self._walk = self._lib.kt_walk_new(
            start_f.ctypes.data, start_r.ctypes.data, self.n, int(k),
            tags.ctypes.data, len(tags), stop_tags.ctypes.data,
            len(stop_tags), int(max_breadth), int(bool(break_on_stop_tags)),
            int(bool(stop_big_traversals)), walk_threads(),
            start_ok.ctypes.data if self.banded else None)

    def tags(self):
        """The tags each traversal found: a list of ascending u64
        arrays."""
        counts = np.empty(self.n, np.int64)
        self._lib.kt_walk_counts(self._walk, counts.ctypes.data)
        flat = np.empty(int(counts.sum()), np.uint64)
        self._lib.kt_walk_tags(self._walk, flat.ctypes.data)
        return np.split(flat, np.cumsum(counts)[:-1])


class SweepWalk(_LevelWalk):
    """The perimeter sweeps of a batch of sequences (csrc/sweep_walk.cc), a
    breadth level of each a pass: sweep i starts from the k-mers (f, r)
    seed_f/seed_r[offsets[i]:offsets[i + 1]], with the graph's tags and
    stop tags, out to `max_breadth`; once the walk has ended, result()
    holds what each found."""

    def __init__(self, seed_f, seed_r, offsets, k, tags, stop_tags,
                 max_breadth, break_on_stop_tags, stop_big_traversals):
        self._lib = library()
        seed_f, seed_r = _u64(seed_f), _u64(seed_r)
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        if (len(offsets) < 1 or offsets[0] != 0 or offsets[-1] != len(seed_f)
                or len(seed_r) != len(seed_f)
                or (np.diff(offsets) < 0).any()):
            raise ValueError("offsets must rise from 0 to the seeds' length")
        tags, stop_tags = _u64(tags), _u64(stop_tags)
        self.n = len(offsets) - 1
        self._walk = self._lib.kt_sweep_new(
            seed_f.ctypes.data, seed_r.ctypes.data, offsets.ctypes.data,
            self.n, int(k), tags.ctypes.data, len(tags),
            stop_tags.ctypes.data, len(stop_tags), int(max_breadth),
            int(bool(break_on_stop_tags)), int(bool(stop_big_traversals)),
            walk_threads())

    def result(self):
        """(the distinct tags each sweep found: a list of ascending u64
        arrays, the nodes each counted: int64 [n])."""
        counts = np.empty(self.n, np.int64)
        totals = np.empty(self.n, np.int64)
        self._lib.kt_sweep_counts(self._walk, counts.ctypes.data,
                                  totals.ctypes.data)
        flat = np.empty(int(counts.sum()), np.uint64)
        self._lib.kt_sweep_tags(self._walk, flat.ctypes.data)
        return np.split(flat, np.cumsum(counts)[:-1]), totals


class ExcursionWalk(_LevelWalk):
    """Bounded-radius traversals of a batch of start k-mers
    (csrc/excursion_walk.cc), a breadth level of each a pass. Once the
    walk has ended, counts() and keepers() give what each traversal kept,
    and evaluate() runs repartition's evaluation of the batch."""

    def __init__(self, start_f, start_r, k, stop_tags, radius, max_count=0):
        if radius < 0:
            raise ValueError("radius must be >= 0")
        self._lib = library()
        start_f, start_r = _u64(start_f), _u64(start_r)
        stop_tags = _u64(stop_tags)
        self.n = len(start_f)
        self.max_count = int(max_count)
        self._walk = self._lib.kt_exc_new(
            start_f.ctypes.data, start_r.ctypes.data, self.n, int(k),
            stop_tags.ctypes.data, len(stop_tags), int(radius),
            self.max_count, walk_threads())

    def counts(self):
        """The nodes each traversal kept (int64 [n])."""
        out = np.empty(self.n, np.int64)
        self._lib.kt_exc_counts(self._walk, out.ctypes.data)
        return out

    def n_keepers(self, least=0):
        """How many nodes the traversals that kept at least `least` kept."""
        counts = self.counts()
        return int(counts[counts >= least].sum())

    def keepers(self, least=0, out=None):
        """The keepers of the traversals that kept at least `least` nodes,
        each ascending, one after another (u64): into the head of `out`
        where it is given (a contiguous u64 array at least that long)."""
        m = self.n_keepers(least)
        if out is None:
            out = np.empty(m, np.uint64)
        elif out.dtype != np.uint64 or out.ndim != 1 or len(out) < m \
                or not out.flags.c_contiguous:
            raise ValueError("out must be a contiguous u64 array of at "
                             "least %d" % m)
        out = out[:m]
        self._lib.kt_exc_keepers(self._walk, int(least), out.ctypes.data)
        return out

    def evaluate(self, base, primes, threshold, frequency, saturation=255):
        """Repartition's evaluation of the batch (see
        csrc/excursion_walk.cc), the traversals in order: base, uint8
        [T, m], each table's counter of keepers(threshold) when the batch
        began, in tables whose counters saturate at `saturation` (255 in
        byte tables, 15 in nibble ones). Returns (the new stop tags, the
        adds, in the order to commit them, whether each traversal's start
        is a small tag, whether each was walked again)."""
        if self.max_count:
            raise ValueError("an evaluation takes walks with no max_count")
        base = np.ascontiguousarray(base, dtype=np.uint8)
        m = self.n_keepers(threshold)
        if base.shape != (len(primes), m):
            raise ValueError("base is %s, not [%d tables, %d k-mers]"
                             % (base.shape, len(primes), m))
        primes = np.ascontiguousarray(primes, dtype=np.int64)
        stops = np.empty(m, np.uint64)
        adds = np.empty(m, np.uint64)
        flags = np.empty(self.n, np.uint8)
        got = np.zeros(2, np.int64)
        self._lib.kt_exc_evaluate(
            self._walk, base.ctypes.data, m, primes.ctypes.data,
            len(primes), int(threshold), int(frequency), int(saturation),
            stops.ctypes.data,
            adds.ctypes.data, flags.ctypes.data, got.ctypes.data)
        return (stops[:got[0]], adds[:got[1]], (flags & 1).astype(bool),
                (flags & 2).astype(bool))
