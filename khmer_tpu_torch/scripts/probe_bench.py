#!/usr/bin/env python
"""Kernel L (csrc/neighbors.cu) on the shapes the partition walk gives
it, on the card, in turns with its variants and, given --parent, with the
parent checkout's kernel.

Shapes (chip_smoke phases 10 and 10b):
  (walk) 10b's walk replayed: do-partition -k 20 -x 8e9 -N 4
      --no-big-traverse on scripts/synth_reads.py's 1,000,000 reads (4 GB
      of bit tables; the tagged consume, then every subset's walk as
      cli/do_partition.py runs it, its union-find left out), each
      frontier recorded in order and replayed once, as
      core/partition._Prober probes a level: the frontier up from a
      pinned buffer, L, the masks back, a sync. L's own time from
      torch.profiler's device entries (a replay of its own), with, a
      level, the host's time to issue the upload, the launch and the copy
      back and its wait in the sync, the device's time of the two copies,
      and CUDA events around each call as chip_smoke reads them (the
      host's launch included); then the frontiers on the card probed in
      order, each launch between CUDA events while a sleep kernel holds
      the stream (scripts.held_ms: the device's gap between launches
      included, which the profiler's time leaves out), its levels split
      by size (BUCKETS: levels, nodes, ms, ns a node); "walk-idle" the
      first two with the host asleep IDLE_MS a level before the upload,
      as if a host pass ran there.
  (big) 10b's largest frontier, back to back (scripts.cuda_ms, as issued;
      scripts.device_ms, the device alone), and each call after a write
      of FLUSH_BYTES (L2 flushed; scripts.reset_ms).
  (stamps) phase 10's largest frontier (the stamps reads at -x 12.5e6,
      6.25 MB of tables, in L2), back to back.
  (fill) (big)'s nodes against 4 GB tables filled otherwise: 10b's own
      (about 0.3% set), and random ones 1/16, 3/8 and all set, back to
      back and flushed.
  (wall) do-partition's wall as phases 10 and 10b run it, with the
      parent's checkout in turns (with --parent; walls).
Each kernel shape has two sector floors (partition_cases.probe_floors, 32 B a
distinct sector, at 3.35 TB/s): every table of every neighbour, and what
a probe that stops at a neighbour's first unset bit needs; and the loads
and sectors of each stage of L's rule (partition_cases.probe_stages).

Sides, each csrc/neighbors.cu built by nvcc into a library of its own
under khmer_tpu_torch/_build/probe_sides/, called as neighbors_cuda calls
it, the answer held to neighbors_plain:
  design    the source as it is: eight lanes a node, each value staged;
  unstaged  kFirst 4: a value's four tables in one stage (no staging);
  thread    a thread a node, its eight values staged together
            (_THREAD_KERNEL);
  shared    the same, with one 32-bit load for the values of a node whose
            bits lie in one word of a table (_SHARED_STAGE);
  parent    DIR/khmer_tpu_torch/csrc/neighbors.cu (with --parent DIR).
Every shape runs them in turns (SIDES' order, then back), in one process,
on the same tensors. One JSON line a shape and side; ptxas's registers
first. Needs a CUDA card; from the repo root:

    python -m khmer_tpu_torch.scripts.probe_bench [--parent DIR]
        [--shapes wall walk big stamps fill]
"""

import argparse
import ctypes
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops import cuda
from khmer_tpu_torch.scripts import (cuda_ms, device_ms, held_ms,
                                     partition_cases, reset_ms)

SHAPES = ("wall", "walk", "big", "stamps", "fill")
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
SECTOR = 32
FLUSH_BYTES = 100 << 20
IDLE_MS = 2.0
REPS = 20
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STAMPS = os.path.join(_REPO, "data", "stamps-reads.fa.gz")
# the stage of the side "shared": values of a node whose bits lie in one
# 32-bit word of a table share one load
_SHARED_STAGE = """template <int kN, int kWidth>
__device__ __forceinline__ unsigned stage_bits(const ByteLayout& layout,
                                               const uint8_t* flat,
                                               const uint64_t* canon,
                                               unsigned live, int t0) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(flat);
  uint32_t word[kWidth][kN];
  uint32_t meta[kWidth][kN];  // bit in the word | the value it loads << 5
#pragma unroll
  for (int g = 0; g < kWidth; ++g) {
    const int t = t0 + g;
    uint64_t w[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      word[g][j] = ~0u;
      meta[g][j] = j << 5;
      if (t < layout.ntables && (live >> j & 1)) {
        const uint64_t b = counter_index(layout, canon[j], t);
        w[j] = b >> 5;
        int src = j;
#pragma unroll
        for (int i = j - 1; i >= 0; --i) {
          if ((live >> i & 1) && w[i] == w[j]) src = i;
        }
        meta[g][j] = static_cast<uint32_t>(b & 31) | src << 5;
        if (src == j) word[g][j] = words[w[j]];
      }
    }
  }
  unsigned out = live;
#pragma unroll
  for (int g = 0; g < kWidth; ++g) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      uint32_t v = word[g][j];
#pragma unroll
      for (int i = 0; i < j; ++i) {
        if (meta[g][j] >> 5 == static_cast<uint32_t>(i)) v = word[g][i];
      }
      if (!(v >> (meta[g][j] & 31) & 1)) out &= ~(1u << j);
    }
  }
  return out;
}

"""
_STAGE = re.compile(r"template <int kN, int kWidth>\n.*?\n}\n\n", re.S)
# kernel L with a thread a node: it computes the node's eight canonical
# values and loads them in the same stages, all eight in a stage at once
_THREAD_KERNEL = """// Bits of the live values of `canon` in tables [t0, t0 + kWidth) (a bit
// of an absent table reads 1), every load issued before any is used.
template <int kN, int kWidth>
__device__ __forceinline__ unsigned stage_bits(const ByteLayout& layout,
                                               const uint8_t* flat,
                                               const uint64_t* canon,
                                               unsigned live, int t0) {
  uint8_t v[kWidth][kN];
#pragma unroll
  for (int g = 0; g < kWidth; ++g) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      v[g][j] = 1;
      if (t0 + g < layout.ntables && (live >> j & 1)) {
        const uint64_t b = counter_index(layout, canon[j], t0 + g);
        v[g][j] = flat[b >> 3] >> (b & 7) & 1;
      }
    }
  }
  unsigned out = live;
#pragma unroll
  for (int g = 0; g < kWidth; ++g) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (!v[g][j]) out &= ~(1u << j);
    }
  }
  return out;
}

template <int kN>
__device__ __forceinline__ unsigned present_bits(const ByteLayout& layout,
                                                 const uint8_t* flat,
                                                 const uint64_t* canon) {
  unsigned live = stage_bits<kN, kFirst>(layout, flat, canon,
                                         (1u << kN) - 1, 0);
  for (int t0 = kFirst; t0 < layout.ntables && live; t0 += kGroup) {
    live = stage_bits<kN, kGroup>(layout, flat, canon, live, t0);
  }
  return live;
}

__global__ void __launch_bounds__(kThreads)
neighbors_kernel(const uint64_t* __restrict__ f,
                 const uint64_t* __restrict__ r, int64_t n, uint64_t mask,
                 int shift, const __grid_constant__ ByteLayout layout,
                 const uint8_t* __restrict__ flat, uint8_t* __restrict__ out) {
  const int64_t i = thread_index();
  if (i >= n) return;
  const uint64_t fi = f[i], ri = r[i];
  uint64_t canon[8];
#pragma unroll
  for (uint64_t b = 0; b < 4; ++b) {
    const uint64_t rf = ((fi << 2) | b) & mask;
    const uint64_t rr = (ri >> 2) | ((b ^ 1) << shift);
    canon[b] = rf < rr ? rf : rr;
    const uint64_t lf = (fi >> 2) | (b << shift);
    const uint64_t lr = ((ri << 2) | (b ^ 1)) & mask;
    canon[4 + b] = lf < lr ? lf : lr;
  }
  out[i] = static_cast<uint8_t>(present_bits<8>(layout, flat, canon));
}

"""
_KERNEL = re.compile(r"__global__ void __launch_bounds__\(kThreads\)\n"
                     r"neighbors_kernel.*?\n}\n", re.S)
_THREAD_GRID = ("neighbors_kernel<<<khmer_cuda::grid_for(8 * n)",
                "neighbors_kernel<<<khmer_cuda::grid_for(n)")
# side -> the edits of csrc/neighbors.cu that make it: (old, new) text or
# (pattern, new)
VARIANTS = {
    "design": (),
    "unstaged": (("constexpr int kFirst = 1;", "constexpr int kFirst = 4;"),),
    "thread": ((_KERNEL, _THREAD_KERNEL), _THREAD_GRID),
    "shared": ((_KERNEL, _STAGE.sub(lambda _: _SHARED_STAGE,
                                    _THREAD_KERNEL)), _THREAD_GRID),
}
SIDES = ("parent", "design", "unstaged", "thread", "shared")
# frontier sizes (nodes) that split the walk's levels (Walk.buckets)
BUCKETS = (4096, 16384, 65536)


def build(parent=None):
    """{side: its khmer_neighbors} built by one nvcc each, all at once;
    and ptxas's registers and spills of each."""
    out_dir = os.path.join(cuda.BUILD_DIR, "probe_sides")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(cuda.CSRC, "neighbors.cu")) as f:
        src = f.read()
    sources = {}
    for side, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if isinstance(old, str):
                hits = text.count(old)
                text = text.replace(old, new)
            else:
                text, hits = old.subn(lambda _: new, text)
            if hits != 1:
                raise RuntimeError("side %s: %r is %d times in the source"
                                   % (side, old, hits))
        sources[side] = (text, cuda.CSRC)
    if parent:
        csrc = os.path.join(os.path.abspath(parent), "khmer_tpu_torch",
                            "csrc")
        with open(os.path.join(csrc, "neighbors.cu")) as f:
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
        fn = lib.khmer_neighbors
        fn.argtypes = cuda._ENTRY_POINTS["khmer_neighbors"]
        fn.restype = ctypes.c_int
        fns[side] = fn
    return fns, reports


def caller(fn, primes, flat, k):
    """probe(f, r) -> masks: what neighbors_cuda does, on side fn."""
    primes_arr, offsets_arr = K._layout(primes, bits=True)
    dev = flat.device

    def probe(f, r):
        K._check_bit_args(primes, flat, f, r)
        out = torch.empty(f.shape[0], dtype=torch.uint8, device=dev)
        cuda.check(fn(flat.data_ptr(), len(primes),
                      ctypes.addressof(primes_arr),
                      ctypes.addressof(offsets_arr), f.data_ptr(),
                      r.data_ptr(), f.shape[0], k, out.data_ptr(),
                      dev.index, K._stream(dev)), "neighbors side")
        return out
    return probe


def walk_graph(reads, x, dev):
    """A Nodegraph(20, x, 4) on `dev` that has consumed and tagged
    `reads`, and the frontiers of do-partition --no-big-traverse's walk
    over it (default subset size), in order, each as one int64 tensor on
    the card (f's then r's)."""
    from khmer_tpu_torch.core import partition as P
    from khmer_tpu_torch.core.sketch import Nodegraph

    g = Nodegraph(20, x, 4, device=dev)
    g.consume_seqfile_and_tag(reads)
    frontiers = []
    fn = K.neighbors

    def record(primes, flat, f, r, k):
        frontiers.append(torch.cat([f, r]))
        return fn(primes, flat, f, r, k)

    tags = P._sorted_tags(g.all_tags)
    arrays = (tags, P._sorted_tags(g.stop_tags))
    divvy = list(g.divide_tags_into_subsets(100000)) + [0]
    K.neighbors = record
    try:
        for start, end in zip(divvy, divvy[1:]):
            lo = P._index(tags, start) if start else 0
            hi = P._index(tags, end) if end else len(tags)
            span = tags[lo:hi]
            P.find_all_tags_batch(g, span, P.revcomp_bits(span, 20), True,
                                  True, arrays)
    finally:
        K.neighbors = fn
    return g, frontiers


def floors_ms(sectors):
    return sectors * SECTOR / PEAK_BYTES_S * 1e3


def shape_counts(primes, flat, f, r, k=20):
    """Both sector floors and the rule's loads and sectors a stage."""
    every, needed = partition_cases.probe_floors(primes, flat, f, r, k)
    _, stages = partition_cases.neighbor_stages(primes, flat, f, r, k)
    return {"nodes": int(f.shape[0]), "every_sectors": every,
            "needed_sectors": needed, "every_floor_ms": floors_ms(every),
            "needed_floor_ms": floors_ms(needed),
            "stages": [[s["tables"], s["rows"], s["loads"], s["sectors"]]
                       for s in stages]}


def _self_device_us(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


class Walk:
    """10b's frontiers in one pinned host buffer, replayed a level at a
    time as partition._Prober probes them."""

    def __init__(self, frontiers, primes, flat, k=20):
        self.primes, self.flat, self.k = primes, flat, k
        self.sizes = [fr.shape[0] // 2 for fr in frontiers]
        self.starts = np.concatenate([[0], np.cumsum(
            [2 * n for n in self.sizes])]).tolist()
        self.host = torch.empty(self.starts[-1], dtype=torch.int64,
                                pin_memory=True)
        for fr, o in zip(frontiers, self.starts):
            self.host[o:o + fr.shape[0]].copy_(fr)
        self.down = torch.empty(max(self.sizes), dtype=torch.uint8,
                                pin_memory=True)
        self.dev = flat.device

    def replay(self, probe, idle_ms=0.0, check=False):
        """Every level once, in order: host seconds of the upload's issue,
        the launch, the copy back's issue and the sync, summed; and the
        CUDA events around each call (ms, summed)."""
        host = np.zeros(4)
        events = []
        bad = 0
        stream = torch.cuda.current_stream(self.dev)
        for n, o in zip(self.sizes, self.starts):
            if idle_ms:
                time.sleep(idle_ms / 1e3)
            t0 = time.perf_counter()
            fr = self.host[o:o + 2 * n].to(self.dev, non_blocking=True)
            t1 = time.perf_counter()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            masks = probe(fr[:n], fr[n:])
            e1.record()
            t2 = time.perf_counter()
            out = self.down[:n]
            out.copy_(masks, non_blocking=True)
            t3 = time.perf_counter()
            stream.synchronize()
            t4 = time.perf_counter()
            host += (t1 - t0, t2 - t1, t3 - t2, t4 - t3)
            events.append((e0, e1))
            if check:
                want = K.neighbors_plain(self.primes, self.flat, fr[:n],
                                         fr[n:], self.k)
                bad += int((want.cpu() != out).sum())
        return host, sum(a.elapsed_time(b) for a, b in events), bad

    def traced(self, probe, idle_ms=0.0):
        """A replay under torch.profiler: L's device ms and kernels, the
        copies' device ms."""
        from torch.autograd import DeviceType

        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            self.replay(probe, idle_ms)
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]

        def named(part):
            hit = [e for e in found if part in e.key]
            return (sum(_self_device_us(e) for e in hit) / 1e3,
                    sum(e.count for e in hit))
        kernel_ms, kernels = named("neighbors_kernel")
        return {"kernel_ms": kernel_ms, "kernels": kernels,
                "htod_ms": named("Memcpy HtoD")[0],
                "dtoh_ms": named("Memcpy DtoH")[0]}

    def held(self, probe):
        """Each level's ms: the frontiers on the card, probed in order,
        timed by scripts.held_ms (events around each launch while the
        stream is held: the device's gap between launches included)."""
        frontiers = [self.host[o:o + 2 * n].to(self.dev)
                     for n, o in zip(self.sizes, self.starts)]
        return held_ms([functools.partial(probe, fr[:n], fr[n:])
                        for n, fr in zip(self.sizes, frontiers)])

    def buckets(self, ms):
        """Levels, nodes, held ms and ns a node of the levels of each size
        range of BUCKETS."""
        edges = (0,) + BUCKETS + (1 << 62,)
        out = []
        for lo, hi in zip(edges, edges[1:]):
            pick = [(n, t) for n, t in zip(self.sizes, ms) if lo <= n < hi]
            nodes = sum(n for n, _ in pick)
            total = sum(t for _, t in pick)
            out.append([lo, len(pick), nodes, total,
                        total * 1e6 / max(nodes, 1)])
        return out

    def time(self, probe, idle_ms=0.0):
        rec = self.traced(probe, idle_ms)
        host, events_ms, _ = self.replay(probe, idle_ms)
        levels = len(self.sizes)
        rec.update(
            levels=levels, nodes=int(sum(self.sizes)),
            whole=rec["kernels"] == levels,
            ns_a_node=rec["kernel_ms"] * 1e6 / sum(self.sizes),
            events_ms=events_ms,
            upload_us=host[0] / levels * 1e6,
            launch_us=host[1] / levels * 1e6,
            copy_back_us=host[2] / levels * 1e6,
            sync_us=host[3] / levels * 1e6)
        if not idle_ms:
            ms = self.held(probe)
            rec.update(held_ms=sum(ms), buckets=self.buckets(ms))
        return rec


def walk_counts(walk):
    """The walk's sector floors and rule counts, summed over its levels."""
    total = {"every_sectors": 0, "needed_sectors": 0, "loads": 0,
             "rule_sectors": 0}
    for n, o in zip(walk.sizes, walk.starts):
        fr = walk.host[o:o + 2 * n].to(walk.dev)
        c = shape_counts(walk.primes, walk.flat, fr[:n], fr[n:])
        total["every_sectors"] += c["every_sectors"]
        total["needed_sectors"] += c["needed_sectors"]
        total["loads"] += sum(s[2] for s in c["stages"])
        total["rule_sectors"] += sum(s[3] for s in c["stages"])
    total["every_floor_ms"] = floors_ms(total["every_sectors"])
    total["needed_floor_ms"] = floors_ms(total["needed_sectors"])
    return total


def fill_tables(flat, kind, seed=16):
    """Overwrite `flat` (u8 on the card) with random bits: "sixteenth"
    (a & b & c & d, 1/16 set), "three-eighths" (a & (b | c)) or "full"."""
    if kind == "full":
        flat.fill_(255)
        return
    gen = torch.Generator(device=flat.device)
    gen.manual_seed(seed)
    step = 1 << 28
    for lo in range(0, flat.shape[0], step):
        part = flat[lo:lo + step]

        def rand():
            return torch.randint(0, 256, part.shape, dtype=torch.uint8,
                                 device=flat.device, generator=gen)
        if kind == "sixteenth":
            part.copy_(rand() & rand() & rand() & rand())
        else:
            part.copy_(rand() & (rand() | rand()))


def occupancy(flat):
    ones = 0
    step = 1 << 28
    for lo in range(0, flat.shape[0], step):
        part = flat[lo:lo + step]
        ones += int(torch.bitwise_and(
            part[:, None] >> torch.arange(8, device=flat.device,
                                          dtype=torch.uint8), 1)
            .sum(dtype=torch.int64))
    return ones / (8 * flat.shape[0])


# one do-partition in a process of its own, its wall on the host's clock
_WALL = ("import sys, time\n"
         "from khmer_tpu_torch.cli import do_partition\n"
         "t0 = time.perf_counter()\n"
         "do_partition.main(sys.argv[1:])\n"
         "print(time.perf_counter() - t0)\n")


def walls(parent, reads, tmp):
    """do-partition as phases 10 (the stamps reads, -x 12.5e6) and 10b
    (`reads`, -x 8e9) run it, -N 4 --no-big-traverse --keep-subsets, on
    the parent's checkout and this one, each run a process of its own:
    one untimed run of 10 a side (the kernels built), then parent,
    change, change, parent. Yields one record a run: its wall and the
    partitions it output."""
    sides = (("parent", os.path.abspath(parent)), ("change", _REPO))
    runs = (("10", STAMPS, "12.5e6"), ("10b", reads, "8e9"))

    def run(root, path, x):
        out = tempfile.mkdtemp(dir=tmp)
        proc = subprocess.run(
            [sys.executable, "-c", _WALL, "-k", "20", "-x", x, "-N", "4",
             "--no-big-traverse", "--keep-subsets",
             os.path.join(out, "g"), path], cwd=out,
            env=dict(os.environ, PYTHONPATH=root), capture_output=True,
            text=True, check=True)
        shutil.rmtree(out)
        return (float(proc.stdout.split()[-1]),
                int(re.search(r"output (\d+) partitions",
                              proc.stderr).group(1)))

    for _, root in sides:
        run(root, STAMPS, "12.5e6")
    for side, root in sides + sides[::-1]:
        for label, path, x in runs:
            wall, parts = run(root, path, x)
            yield {"shape": "wall", "phase": label, "side": side,
                   "wall_s": wall, "partitions": parts}


def order(sides):
    """The sides in turns: each once, then back."""
    first = [s for s in SIDES if s in sides]
    return first + first[::-1]


def time_frontier(probe, f, r, flush):
    return {"ms": cuda_ms(lambda: probe(f, r), REPS),
            "device_ms": device_ms(lambda: probe(f, r), REPS),
            "flushed_ms": reset_ms(flush, lambda: probe(f, r), REPS,
                                   True)[0]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", choices=SHAPES,
                    default=list(SHAPES))
    ap.add_argument("--parent", metavar="DIR",
                    help="time the kernel of the checkout at DIR in turns")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_bench needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = "%s [%s]" % (torch.cuda.get_device_name(dev), subprocess.run(
        ["nvidia-smi", "-i", str(dev.index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    cuda.library()
    fns, reports = build(a.parent)
    print(json.dumps({"card": card, "ptxas": reports}), flush=True)
    with tempfile.TemporaryDirectory(prefix=".graph_bench_",
                                     dir=_REPO) as tmp:
        reads = None
        if {"wall", "walk", "big", "fill"} & set(a.shapes):
            from khmer_tpu_torch.scripts.synth_reads import write_reads

            reads = os.path.join(tmp, "synth.fa")
            write_reads(reads)
        if "wall" in a.shapes and not a.parent:
            raise SystemExit("shape wall needs --parent")
        run_shapes(a.shapes, fns, card, dev, reads)
        torch.cuda.empty_cache()
        if "wall" in a.shapes:
            for rec in walls(a.parent, reads, tmp):
                print(json.dumps(dict(rec, card=card)), flush=True)


def run_shapes(shapes, fns, card, dev, reads):
    """The kernel shapes of `shapes` on each side of `fns`, in turns."""
    turns = order(fns)
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def emit(shape, side, rec, **extra):
        print(json.dumps(dict(shape=shape, side=side, card=card, **extra,
                              **rec)), flush=True)

    def check(probe, primes, flat, f, r, label):
        got = probe(f, r)
        want = K.neighbors_plain(primes, flat, f, r, 20)
        if not torch.equal(got, want):
            raise AssertionError("%s: %d bytes differ from neighbors_plain"
                                 % (label, int((got != want).sum())))

    if "stamps" in shapes:
        g, frontiers = walk_graph(STAMPS, 12.5e6, dev)
        fr = max(frontiers, key=len)
        n = fr.shape[0] // 2
        f, r = fr[:n], fr[n:]
        primes, flat = g._primes, g.tables.flat
        counts = shape_counts(primes, flat, f, r)
        for side in turns:
            probe = caller(fns[side], primes, flat, 20)
            check(probe, primes, flat, f, r, "stamps " + side)
            emit("stamps", side, time_frontier(probe, f, r, flush),
                 **counts)
        del g, frontiers, fr, f, r, flat
        torch.cuda.empty_cache()
    if not {"walk", "big", "fill"} & set(shapes):
        return
    t0 = time.perf_counter()
    g, frontiers = walk_graph(reads, 8e9, dev)
    record_s = time.perf_counter() - t0
    primes, flat = g._primes, g.tables.flat
    fr = max(frontiers, key=len)
    n = fr.shape[0] // 2
    f, r = fr[:n].clone(), fr[n:].clone()
    if "walk" in shapes:
        walk = Walk(frontiers, primes, flat)
        del frontiers
        torch.cuda.empty_cache()
        counts = walk_counts(walk)
        print(json.dumps(dict(shape="walk", side="counts",
                              record_s=record_s, **counts)), flush=True)
        for side in turns:
            probe = caller(fns[side], primes, flat, 20)
            _, _, bad = walk.replay(probe, check=True)
            if bad:
                raise AssertionError("walk %s: %d bytes differ from "
                                     "neighbors_plain" % (side, bad))
            emit("walk", side, walk.time(probe))
            if side in ("parent", "design"):
                emit("walk-idle", side, walk.time(probe, IDLE_MS))
        del walk
    else:
        del frontiers
    torch.cuda.empty_cache()
    counts = shape_counts(primes, flat, f, r)
    if "big" in shapes:
        for side in turns:
            probe = caller(fns[side], primes, flat, 20)
            check(probe, primes, flat, f, r, "big " + side)
            emit("big", side, time_frontier(probe, f, r, flush), **counts)
    if "fill" in shapes:
        real = occupancy(flat)
        other = torch.empty_like(flat)
        for kind in ("real", "sixteenth", "three-eighths", "full"):
            tables = flat
            if kind != "real":
                fill_tables(other, kind)
                tables = other
            c = dict(shape_counts(primes, tables, f, r), fill=kind,
                     occupancy=real if kind == "real" else occupancy(tables))
            for side in turns:
                probe = caller(fns[side], primes, tables, 20)
                check(probe, primes, tables, f, r, kind + " " + side)
                emit("fill", side, time_frontier(probe, f, r, flush), **c)


if __name__ == "__main__":
    sys.exit(main())
