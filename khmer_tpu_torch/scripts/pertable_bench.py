#!/usr/bin/env python
"""Kernel M (csrc/byte_gather.cu khmer_byte_pertable) on the shapes of the
knot pipeline and on shapes with no repeats, on the card, in turns with
its variants and, given --parent, with the parent checkout's kernel.

Shapes:
  (a) phase 11's largest call: load-graph -k 20 -x 12.5e6 -N 4 and
      make-initial-stoptags -k 20 -x 2e8 -N 4 on the stamps reads, run
      here; the largest call's hashes (a batch's keepers, which repeat
      k-mers) into the 4 x 200 MB counting tables as the CLI leaves them
      (as chip_smoke.py's _pertable_check keeps it).
  (b) NHASH distinct hashes from a seed (synth_hashes) into 4 tables of
      200 MB (primes near 2e8) of seeded random bytes (random_tables): no
      repeats, every read a DRAM sector.
  (c) phase 11b's largest call: find-knots -x 2e8 -N 4 on load-graph -k
      20 -x 8e9 -N 4 of synth_reads.py's 1,000,000 reads (4 GB of bit
      tables) with do-partition --no-big-traverse --keep-subsets' six
      subsets, read in sorted order.
  (d) (b)'s hashes into 4 tables of 1 GB (primes near 1e9).
Each side and shape is read hot (back to back: scripts.cuda_ms as issued,
scripts.device_ms the device alone) and cold (each call after a write of
FLUSH_BYTES, which flushes L2: scripts.reset_ms, as issued and the device
alone), beside torch.take of the joined tables at precomputed indices
(the library call), the bytes bound (8 B in and T B out a hash), the
sector floor (32 B a distinct sector at 3.35 TB/s) and lookups a second.
Every side's answer is held to torch.take's on every shape.

Sides, each csrc/byte_gather.cu built by nvcc into a library of its own
under khmer_tpu_torch/_build/pertable_sides/, called as
byte_pertable_cuda calls it:
  design    the source as it is (a hash a thread, grid row y on table y,
            the cache hints);
  nohints   without its cache hints (kCacheHints false);
  loop      the same kernel written as a loop over chunks, tables and
            tiles with its choices as constants (_LOOP_KERNEL), which the
            sides below set;
  two, four, eight
            2, 4 or 8 hashes a thread, their loads issued together
            (kPerTableThread);
  pairs, all
            2 or 4 tables on one load of the hashes (kTablesAtOnce);
  chunked   chunk-major (kChunkHashes 2^21: every table of a chunk of
            hashes before the next chunk);
  card      8 hashes a thread and a grid of as many blocks as the SMs
            hold, striding over each table's tiles (kGridToCard);
  parent    DIR/khmer_tpu_torch/csrc/byte_gather.cu (with --parent DIR).
Every shape runs them in turns (SIDES' order, then back), in one process,
on the same tensors. On (a) it also times the caller's round trip through
the design's kernel, in turns: "pageable" as the parent's repartition
made it (the keepers into a new array, a copy, a pageable upload, the
counters back by .cpu()) and "pinned" as partition._Staging makes it
(the keepers into a pinned buffer, one upload, the counters back into
another); upload and copy back on the host's clock around a sync, the
kernel by CUDA events. One JSON line a shape and side; ptxas's registers
first. Needs a CUDA card; from the repo root:

    python -m khmer_tpu_torch.scripts.pertable_bench [--parent DIR]
        [--shapes a b c d]
"""

import argparse
import ctypes
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops import cuda
from khmer_tpu_torch.scripts import cuda_ms, device_ms, reset_ms

SHAPES = ("a", "b", "c", "d")
# primes near x of the tables of (b) and (d), four each
SYNTH_TABLES = {"b": 2e8, "d": 1e9}
NHASH = 8_775_042  # the hashes of phase 11's largest call
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
SECTOR = 32
FLUSH_BYTES = 100 << 20
REPS = 20
TRIPS = 5  # round trips a turn on (a)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STAMPS = os.path.join(_REPO, "data", "stamps-reads.fa.gz")
# kernel M as a loop over tiles, tables and chunks, with its choices as
# constants: the design is kPerTableThread 1, kTablesAtOnce 1, kChunkHashes 0
# and kGridToCard false, to which it reduces (side "loop")
_LOOP_KERNEL = """constexpr int kPerTableThread = 1;
constexpr int kTablesAtOnce = 1;
constexpr int64_t kChunkHashes = 0;
constexpr bool kGridToCard = false;

__global__ void __launch_bounds__(kPerTableBlock)
pertable_kernel(const uint64_t* __restrict__ hashes, int64_t n,
                int64_t tiles, int64_t chunk_tiles,
                const __grid_constant__ ByteLayout layout,
                const uint8_t* __restrict__ flat,
                uint8_t* __restrict__ out) {
  constexpr int P = kPerTableThread;
  constexpr int G = kTablesAtOnce;
  const uint64_t policy = keep_policy();
  for (int64_t c0 = 0; c0 < tiles; c0 += chunk_tiles) {
    const int64_t c1 = c0 + chunk_tiles < tiles ? c0 + chunk_tiles : tiles;
    for (int t0 = blockIdx.y * G; t0 < layout.ntables;
         t0 += gridDim.y * G) {
      for (int64_t tile = c0 + blockIdx.x; tile < c1; tile += gridDim.x) {
        const int64_t first =
            tile * P * kPerTableBlock + static_cast<int64_t>(threadIdx.x);
        uint64_t h[P];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const int64_t i = first + k * kPerTableBlock;
          h[k] = i < n ? load_hash(hashes + i) : 0;
        }
        unsigned v[G][P];
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int k = 0; k < P; ++k) {
            v[g][k] = t0 + g < layout.ntables
                          ? load_counter(flat + counter_index(layout, h[k],
                                                              t0 + g),
                                         policy)
                          : 0;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (t0 + g >= layout.ntables) break;
          uint8_t* row = out + (t0 + g) * n;
#pragma unroll
          for (int k = 0; k < P; ++k) {
            const int64_t i = first + k * kPerTableBlock;
            if (i < n) store_counter(row + i, v[g][k]);
          }
        }
      }
    }
  }
}

}  // namespace
}  // namespace khmer_byte

// out[t * n + i] = flat[offsets[t] + hashes[i] % primes[t]], for t <
// ntables and i < n: kernel M. primes/offsets are HOST arrays of ntables.
extern "C" int khmer_byte_pertable(const uint8_t* flat, int ntables,
                                   const int64_t* primes,
                                   const int64_t* offsets,
                                   const int64_t* hashes, int64_t n,
                                   uint8_t* out, int device, void* stream) {
  using namespace khmer_byte;
  ByteLayout layout;
  if (!make_layout(ntables, primes, offsets, &layout) || n < 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  const int64_t per_tile = int64_t{kPerTableThread} * kPerTableBlock;
  const int64_t tiles = (n + per_tile - 1) / per_tile;
  const int64_t chunk_tiles =
      kChunkHashes >= per_tile ? kChunkHashes / per_tile : tiles;
  dim3 grid(static_cast<unsigned>(chunk_tiles < tiles ? chunk_tiles : tiles),
            static_cast<unsigned>((ntables + kTablesAtOnce - 1)
                                  / kTablesAtOnce));
  if constexpr (kGridToCard) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pertable_kernel, kPerTableBlock, 0);
    if (err != cudaSuccess) return err;
    const int64_t most = int64_t{sms} * (per_sm > 0 ? per_sm : 1);
    grid = dim3(static_cast<unsigned>(grid.x < most ? grid.x : most), 1);
  }
  pertable_kernel<<<grid, kPerTableBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint64_t*>(hashes), n, tiles, chunk_tiles,
      layout, flat, out);
  return cudaGetLastError();
}

"""
# the design's kernel and its C entry point, which _LOOP_KERNEL replaces
_KERNEL = re.compile(r"__global__ void __launch_bounds__\(kPerTableBlock\)\n"
                     r"pertable_kernel.*?return cudaGetLastError\(\);\n}\n",
                     re.S)
_LOOP = (_KERNEL, _LOOP_KERNEL)
_ONE = "constexpr int kPerTableThread = 1;"
_TABLES = "constexpr int kTablesAtOnce = 1;"
# side -> the edits of csrc/byte_gather.cu that make it: (old text or
# pattern, new)
VARIANTS = {
    "design": (),
    "nohints": (("constexpr bool kCacheHints = true;",
                 "constexpr bool kCacheHints = false;"),),
    "loop": (_LOOP,),
    "two": (_LOOP, (_ONE, "constexpr int kPerTableThread = 2;")),
    "four": (_LOOP, (_ONE, "constexpr int kPerTableThread = 4;")),
    "eight": (_LOOP, (_ONE, "constexpr int kPerTableThread = 8;")),
    "pairs": (_LOOP, (_TABLES, "constexpr int kTablesAtOnce = 2;")),
    "all": (_LOOP, (_TABLES, "constexpr int kTablesAtOnce = 4;")),
    "chunked": (_LOOP, ("constexpr int64_t kChunkHashes = 0;",
                        "constexpr int64_t kChunkHashes = int64_t{1} << 21;")),
    "card": (_LOOP, ("constexpr bool kGridToCard = false;",
                     "constexpr bool kGridToCard = true;"),
             (_ONE, "constexpr int kPerTableThread = 8;")),
}
SIDES = ("parent",) + tuple(VARIANTS)


def variant_source(src, side):
    """csrc/byte_gather.cu's text `src` with side's edits made; raises
    unless each edit finds its text once."""
    for old, new in VARIANTS[side]:
        if isinstance(old, str):
            hits = src.count(old)
            src = src.replace(old, new)
        else:
            src, hits = old.subn(lambda _: new, src)
        if hits != 1:
            raise RuntimeError("side %s: %r is %d times in the source"
                               % (side, old, hits))
    return src


def synth_hashes(n, seed=18):
    """n distinct u64 hashes from a seed: splitmix64's finalizer, a
    bijection, of seed * 2^40 + 0..n-1."""
    z = (np.arange(n, dtype=np.uint64) + np.uint64(seed << 40)
         + np.uint64(0x9E3779B97F4A7C15))
    with np.errstate(over="ignore"):
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def shape_primes(shape):
    """The four primes of shape (b) or (d)'s tables."""
    return tuple(K.get_n_primes_near_x(4, SYNTH_TABLES[shape]))


def random_tables(primes, dev, seed=18):
    """The joined byte tables of `primes` on `dev`, seeded random bytes."""
    flat = torch.empty(K.byte_flat_size(primes), dtype=torch.uint8,
                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    step = 1 << 28
    for lo in range(0, flat.shape[0], step):
        part = flat[lo:lo + step]
        part.copy_(torch.randint(0, 256, part.shape, dtype=torch.uint8,
                                 device=dev, generator=gen))
    return flat


def flat_indices(primes, hashes):
    """Every (table, hash)'s index in the joined tables, int64 [T, n]."""
    from khmer_tpu_torch.ops.u64 import umod

    return torch.stack([umod(hashes, p) + off for off, p in
                        zip(K.byte_offsets(primes), primes)])


def shape_counts(primes, flat, hashes, idx):
    """A shape's size, bytes bound and sector floor."""
    n, T = hashes.shape[0], len(primes)
    sectors = int(torch.unique(idx >> 5).shape[0])
    return {"hashes": n, "tables": T, "table_bytes": int(flat.shape[0]),
            "bound_ms": (8 + T) * n / PEAK_BYTES_S * 1e3,
            "sectors": sectors,
            "floor_ms": sectors * SECTOR / PEAK_BYTES_S * 1e3}


def readings(fn, flush, lookups):
    """fn's ms hot (as issued, the device alone) and cold (each call after
    flush(): as issued, the device alone), and lookups a second."""
    rec = {"ms": cuda_ms(fn, REPS), "device_ms": device_ms(fn, REPS),
           "cold_ms": reset_ms(flush, fn, REPS, False)[0],
           "cold_device_ms": reset_ms(flush, fn, REPS, True)[0]}
    rec["lookups_s"] = lookups / rec["device_ms"] * 1e3
    rec["cold_lookups_s"] = lookups / rec["cold_device_ms"] * 1e3
    return rec


def build(parent=None):
    """{side: its khmer_byte_pertable} built by one nvcc each, all at
    once; and ptxas's registers and spills of each (kernels B and M)."""
    out_dir = os.path.join(cuda.BUILD_DIR, "pertable_sides")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda.CSRC, "byte_gather.cu")) as f:
        src = f.read()
    sources = {side: (variant_source(src, side), cuda.CSRC)
               for side in VARIANTS}
    if parent:
        csrc = os.path.join(os.path.abspath(parent), "khmer_tpu_torch",
                            "csrc")
        with open(os.path.join(csrc, "byte_gather.cu")) as f:
            sources["parent"] = (f.read(), csrc)
    procs = {}
    for side, (text, include) in sources.items():
        cu = os.path.join(out_dir, side + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[side] = subprocess.Popen(
            [cuda._nvcc()] + cuda.ARCH_FLAGS
            + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
               "-Xptxas", "-v", "-I", include, "-o",
               os.path.join(out_dir, side + ".so"), cu],
            stderr=subprocess.PIPE, text=True)
    fns, reports = {}, {}
    for side, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed on side %s:\n%s" % (side, err))
        reports[side] = [line.split("ptxas info    :")[-1].strip()
                         for line in err.splitlines()
                         if "registers" in line or "spill" in line]
        lib = ctypes.CDLL(os.path.join(out_dir, side + ".so"))
        fn = lib.khmer_byte_pertable
        fn.argtypes = cuda._ENTRY_POINTS["khmer_byte_pertable"]
        fn.restype = ctypes.c_int
        fns[side] = fn
    return fns, reports


def caller(fn, primes, flat):
    """gather(hashes) -> uint8 [T, n]: what byte_pertable_cuda does, on
    side fn."""
    primes_arr, offsets_arr = K._layout(primes)
    dev = flat.device

    def gather(hashes):
        K._check_byte_args(primes, flat, hashes)
        out = torch.empty((len(primes), hashes.shape[0]), dtype=torch.uint8,
                          device=dev)
        cuda.check(fn(flat.data_ptr(), len(primes),
                      ctypes.addressof(primes_arr),
                      ctypes.addressof(offsets_arr), hashes.data_ptr(),
                      hashes.shape[0], out.data_ptr(), dev.index,
                      K._stream(dev)), "byte_pertable side")
        return out
    return gather


def _run(main, args, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        main(args)
    finally:
        os.chdir(old)


def largest_call(steps, cwd):
    """Run the CLIs `steps` ((main, args), ...) in `cwd`, each in this
    process; the largest call of sketch_kernels.byte_pertable among them:
    (primes, its tables as the CLIs leave them, its hashes)."""
    fn = K.byte_pertable
    largest = []

    def keep(primes, flat, hashes):
        if not largest or hashes.shape[0] > largest[0][2].shape[0]:
            largest[:] = [(primes, flat, hashes.clone())]
        return fn(primes, flat, hashes)

    real = glob.glob
    glob.glob = lambda pattern, *a, **kw: sorted(real(pattern, *a, **kw))
    K.byte_pertable = keep
    try:
        for main, args in steps:
            _run(main, args, cwd)
    finally:
        K.byte_pertable = fn
        glob.glob = real
    return largest[0]


def knot_call(shape, tmp):
    """Shape (a) or (c)'s largest call, captured from the CLIs."""
    from khmer_tpu_torch.cli import (do_partition, find_knots, load_graph,
                                     make_initial_stoptags)

    cwd = tempfile.mkdtemp(dir=tmp)
    if shape == "a":
        steps = ((load_graph.main, ["-k", "20", "-x", "12.5e6", "-N", "4",
                                    "g", STAMPS]),
                 (make_initial_stoptags.main,
                  ["-k", "20", "-x", "2e8", "-N", "4", "g"]))
    else:
        from khmer_tpu_torch.scripts.synth_reads import write_reads

        reads = os.path.join(cwd, "synth.fa")
        write_reads(reads)
        steps = ((load_graph.main, ["-k", "20", "-x", "8e9", "-N", "4", "g",
                                    reads]),
                 (do_partition.main, ["-k", "20", "-x", "8e9", "-N", "4",
                                      "--no-big-traverse", "--keep-subsets",
                                      "g", reads]),
                 (find_knots.main, ["-x", "2e8", "-N", "4", "g"]))
    return largest_call(steps, cwd)


class _Walk:
    """The keepers of a call as ExcursionWalk hands them out."""

    def __init__(self, kms):
        self.kms = kms

    def n_keepers(self, least=0):
        return len(self.kms)

    def keepers(self, least=0, out=None):
        if out is None:
            return self.kms.copy()
        out[:len(self.kms)] = self.kms
        return out[:len(self.kms)]


def round_trips(primes, flat, hashes):
    """The caller's upload, M and copy back on a call, "pageable" as the
    parent's repartition made them and "pinned" as partition._Staging
    does, in turns: ms a call of each step (mean over TRIPS calls a turn,
    two turns), and the first pinned call's (its buffers allocated)."""
    from khmer_tpu_torch.core.partition import _Staging
    from khmer_tpu_torch.core.sketch import _hashes_tensor

    dev = flat.device
    walk = _Walk(hashes.cpu().numpy().view(np.uint64))
    want = K.byte_pertable_cuda(primes, flat, hashes).cpu().numpy()

    def trip(kind, staging):
        t0 = time.perf_counter()
        if kind == "pageable":
            up = _hashes_tensor(walk.keepers(), dev)
        else:
            up = staging.upload(walk, 0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        base = K.byte_pertable_cuda(primes, flat, up)
        e1.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        got = (base.cpu().numpy() if kind == "pageable"
               else staging.download(base))
        t3 = time.perf_counter()
        if not np.array_equal(got, want):
            raise AssertionError("round trip %s differs" % kind)
        return np.array([(t1 - t0) * 1e3, e0.elapsed_time(e1),
                         (t3 - t2) * 1e3])

    staging = _Staging(dev)
    first = trip("pinned", staging)
    total = {"pageable": np.zeros(3), "pinned": np.zeros(3)}
    for kind in ("pageable", "pinned", "pinned", "pageable"):
        for _ in range(TRIPS):
            total[kind] += trip(kind, staging)
    out = {kind: dict(zip(("upload_ms", "kernel_ms", "copy_back_ms"),
                          (v / (2 * TRIPS)).tolist()))
           for kind, v in total.items()}
    out["pinned_first"] = dict(zip(("upload_ms", "kernel_ms",
                                    "copy_back_ms"), first.tolist()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", choices=SHAPES,
                    default=list(SHAPES))
    ap.add_argument("--parent", metavar="DIR",
                    help="time the kernel of the checkout at DIR in turns")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("pertable_bench needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = "%s [%s]" % (torch.cuda.get_device_name(dev), subprocess.run(
        ["nvidia-smi", "-i", str(dev.index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    cuda.library()
    fns, reports = build(a.parent)
    print(json.dumps({"card": card, "ptxas": reports}), flush=True)
    turns = [s for s in SIDES if s in fns]
    turns += turns[::-1]
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    with tempfile.TemporaryDirectory(prefix=".pertable_bench_",
                                     dir=_REPO) as tmp:
        for shape in a.shapes:
            t0 = time.perf_counter()
            if shape in SYNTH_TABLES:
                primes = shape_primes(shape)
                flat = random_tables(primes, dev)
                hashes = torch.from_numpy(synth_hashes(NHASH).view(
                    np.int64)).to(dev)
            else:
                primes, flat, hashes = knot_call(shape, tmp)
            setup_s = time.perf_counter() - t0
            idx = flat_indices(primes, hashes)
            want = torch.take(flat, idx)
            counts = dict(shape_counts(primes, flat, hashes, idx),
                          setup_s=setup_s)
            lookups = idx.numel()
            for i, side in enumerate(turns):
                gather = caller(fns[side], primes, flat)
                if not torch.equal(gather(hashes), want):
                    raise AssertionError("shape %s side %s differs from "
                                         "torch.take" % (shape, side))
                if i == 0 or i == len(turns) - 1:
                    print(json.dumps(dict(
                        shape=shape, side="torch.take", card=card,
                        **counts, **readings(lambda: torch.take(flat, idx),
                                             flush, lookups))), flush=True)
                print(json.dumps(dict(
                    shape=shape, side=side, card=card, **counts,
                    **readings(lambda: gather(hashes), flush, lookups))),
                    flush=True)
            if shape == "a":
                print(json.dumps(dict(shape="a", side="round trip",
                                      card=card, **round_trips(
                                          primes, flat, hashes))),
                      flush=True)
            del primes, flat, hashes, idx, want
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
