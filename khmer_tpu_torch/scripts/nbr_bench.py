#!/usr/bin/env python
"""Kernel N (csrc/neighbors.cu) and the walks' round trip on the shapes of
chip_smoke.py phases 12 and 12b, on the card, in turns with the parent
checkout's kernel and walk (--parent DIR).

Shapes:
  (levels) every level of 12b's walk (Countgraph(20, 1e9, 4), bigcount on,
      tagged from scripts/synth_reads.py's 1,000,000 reads: 4 GB of byte
      tables; do_subset_partition_with_abundance(2, 200) cutting big
      traversals) and of phase 12's (Countgraph(20, 12.5e6, 4) on the
      stamps reads: do_subset_partition and the same abundance partition,
      both cutting big traversals, and the sweeps of the first 1,000 reads
      at ranges 0 and 81), recorded with scripts/level_tap.py (the
      frontiers and each walk's band) and replayed on each side: the
      whole walk by held events (scripts.held_ms: the device's time, its
      gap between launches included), and each level cold (the same, a
      write of FLUSH_BYTES that flushes L2 issued ahead of each level
      outside its events), the levels bucketed by size
      (BUCKETS: levels, nodes, ms, ns a node) to set the crossover between
      N's modes.
  (largest) each walk's largest level hot (scripts.cuda_ms as issued,
      scripts.device_ms the device alone) and cold, with its byte bound
      and both sector floors (countgraph_cases.byte_probe_floors).
  (wall) the walks as a user runs them, a process each, in turns
      (parent, change, change-own, then back, then again, after an
      untimed run of the parent and the change that builds their
      kernels): phase 12's partition, abundance partition and sweeps, and
      12b's abundance partition; each step's wall, its walks' (batch_s)
      and the probes' host seconds (the parent: its Python loop's probe
      calls and C++ passes, pass_s; the change: the walk's clocks,
      kt_level_stats, and the probe context's, LevelProbe.stats: passes,
      frontier, upload, launch, copy back, sync), and a digest of its
      answer, which every side must share. change-own is the change with
      each level in the walk's own storage, not the context's pinned
      block (the probe then copies from pageable memory).

Sides of the kernel shapes, each on the same tensors in one process:
  parent  DIR/khmer_tpu_torch/csrc/neighbors.cu's khmer_byte_neighbors
          (built by nvcc under khmer_tpu_torch/_build/nbr_sides/);
  staged  this tree's N in its staged mode (eight lanes a node, table 0
          first);
  small   this tree's N in its small-level mode (a lane a (neighbour,
          table) pair);
  auto    this tree's N, its mode by sketch_kernels.NBR_SMALL_NODES (the
          walk's choice).
Every side's bytes are held to byte_neighbors_plain on every level. One
JSON line a shape and side, the card's name and power limit in each.
Needs a CUDA card; from the repo root (unpack the parent into _parent/):

    python -m khmer_tpu_torch.scripts.nbr_bench [--parent DIR]
        [--shapes levels largest wall]
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SHAPES = ("levels", "largest", "wall")
SIDES = ("parent", "staged", "small", "auto")
FLUSH_BYTES = 100 << 20
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
REPS = 20
BUCKETS = (64, 256, 1024, 4096, 16384, 65536, 262144)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STAMPS = os.path.join(_REPO, "data", "stamps-reads.fa.gz")
BAND = (2, 200)
# the walks whose largest levels shape (largest) times: phase 12's
# (2,977,731 nodes) and 12b's
LARGEST = ("12 sweep 81", "12b abundance")


def _card():
    dev = torch.device("cuda", torch.cuda.current_device())
    return "%s [%s]" % (torch.cuda.get_device_name(dev), subprocess.run(
        ["nvidia-smi", "-i", str(dev.index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())


def build_parent(parent):
    """The parent's khmer_byte_neighbors, built by nvcc, with ptxas's
    registers."""
    from khmer_tpu_torch.ops import cuda

    out_dir = os.path.join(cuda.BUILD_DIR, "nbr_sides")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(os.path.abspath(parent), "khmer_tpu_torch", "csrc")
    lib_path = os.path.join(out_dir, "parent.so")
    proc = subprocess.run(
        [cuda._nvcc()] + cuda.ARCH_FLAGS
        + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-Xptxas",
           "-v", "-I", csrc, "-o", lib_path,
           os.path.join(csrc, "neighbors.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed on the parent:\n%s" % proc.stderr)
    fn = ctypes.CDLL(lib_path).khmer_byte_neighbors
    # the parent's entry point: this tree's without its `small` argument
    args = list(cuda._ENTRY_POINTS["khmer_byte_neighbors"])
    fn.argtypes = args[:15] + args[16:]
    fn.restype = ctypes.c_int
    report = [line.split("ptxas info    :")[-1].strip()
              for line in proc.stderr.splitlines()
              if "registers" in line or "spill" in line]
    return fn, report


def callers(parent_fn):
    """{side: call(graph state, f, r) -> bytes} of the sides."""
    from khmer_tpu_torch.core import sketch_kernels as K
    from khmer_tpu_torch.ops import cuda

    def ours(small):
        def call(st, f, r):
            return K.byte_neighbors_cuda(st["primes"], st["flat"], f, r,
                                         st["k"], st["band"], st["big"],
                                         small)
        return call

    def parent(st, f, r):
        flat, dev, n = st["flat"], st["flat"].device, f.shape[0]
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        band = None if st["band"] is None else torch.empty_like(out)
        keys, values = st["big"] or (None, None)
        primes_arr, offsets_arr = K._layout(st["primes"])
        cuda.check(parent_fn(
            flat.data_ptr(), len(st["primes"]), ctypes.addressof(primes_arr),
            ctypes.addressof(offsets_arr), f.data_ptr(), r.data_ptr(), n,
            st["k"], *K._band_args(*(st["band"] or (1, 255))),
            K._ptr(keys), K._ptr(values),
            0 if keys is None else keys.shape[0], out.data_ptr(),
            K._ptr(band), dev.index, K._stream(dev)), "parent N")
        return out if band is None else (out, band)

    sides = {"staged": ours(False), "small": ours(True), "auto": ours(None)}
    if parent_fn is not None:
        sides["parent"] = parent
    return sides


def order(sides):
    """The sides in turns: each once, then back."""
    first = [s for s in SIDES if s in sides]
    return first + first[::-1]


def record(fn, tmp):
    """Run fn (a walk) with the level tap on: (its levels' (f, r) on the
    card, the walk's state: primes, flat, k, band, big); None where it
    probed no level (a sweep at range 0)."""
    from khmer_tpu_torch.scripts.level_tap import LevelTap

    tap = LevelTap("byte", every=1 << 30, spool=os.path.join(tmp, "spool"))
    remove = tap.install()
    try:
        fn()
    finally:
        remove()
    if tap.largest is None:
        return None
    prober = tap.largest[2]
    g = prober.graph
    state = {"primes": g._primes, "flat": g.tables.flat, "k": g.ksize(),
             "band": prober.band, "big": prober.big}
    levels = tap.replay(g.tables.flat.device)
    os.remove(tap.spool_path)
    return levels, state


def bucketed(sizes, ms):
    """Levels, nodes, ms and ns a node of the levels of each size range."""
    edges = (0,) + BUCKETS + (1 << 62,)
    out = []
    for lo, hi in zip(edges, edges[1:]):
        pick = [(n, t) for n, t in zip(sizes, ms) if lo <= n < hi]
        nodes = sum(n for n, _ in pick)
        total = sum(t for _, t in pick)
        if pick:
            out.append([lo, len(pick), nodes, total,
                        total * 1e6 / max(nodes, 1)])
    return out


def check_side(call, st, levels, label):
    from khmer_tpu_torch.core import sketch_kernels as K

    for f, r in levels:
        got = call(st, f, r)
        want = K.byte_neighbors_plain(st["primes"], st["flat"], f, r,
                                      st["k"], st["band"], st["big"])
        pairs = zip(got, want) if st["band"] is not None else [(got, want)]
        for a, b in pairs:
            if not torch.equal(a, b):
                raise AssertionError("%s: %d bytes differ from plain"
                                     % (label, int((a != b).sum())))


def run_levels(walks, sides, card, emit):
    from khmer_tpu_torch.scripts import held_ms

    dev = torch.device("cuda", torch.cuda.current_device())
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for label, (levels, st) in walks.items():
        sizes = [f.shape[0] for f, _ in levels]
        checked = set()
        for side in order(sides):
            call = sides[side]
            if side not in checked:
                check_side(call, st, levels, "%s %s" % (label, side))
                checked.add(side)
            calls = [lambda f=f, r=r: call(st, f, r) for f, r in levels]
            held = held_ms(calls)
            cold = held_ms(calls, before=scratch.zero_)
            emit("levels", side, walk=label, levels=len(levels),
                 nodes=sum(sizes), held_ms=sum(held),
                 held_buckets=bucketed(sizes, held),
                 cold_ms=sum(cold), cold_buckets=bucketed(sizes, cold))


def run_largest(walks, sides, card, emit):
    from khmer_tpu_torch.core.sketch_kernels import NBR_SMALL_NODES
    from khmer_tpu_torch.scripts import cuda_ms, device_ms, reset_ms
    from khmer_tpu_torch.scripts.countgraph_cases import byte_probe_floors

    dev = torch.device("cuda", torch.cuda.current_device())
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for label in LARGEST:
        levels, st = walks[label]
        picks = {"largest": max(levels, key=lambda l: l[0].shape[0])}
        below = [l for l in levels if l[0].shape[0] < NBR_SMALL_NODES]
        if below and len(below) < len(levels):
            picks["largest small"] = max(below, key=lambda l: l[0].shape[0])
        for which, (f, r) in picks.items():
            n = f.shape[0]
            every, needed, loads = byte_probe_floors(st["primes"],
                                                     st["flat"], f, r,
                                                     st["k"])
            counts = {
                "walk": label, "level": which, "nodes": n,
                "bound_ms": (16 + (1 if st["band"] is None else 2)) * n
                / PEAK_BYTES_S * 1e3,
                "every_floor_ms": every * 32 / PEAK_BYTES_S * 1e3,
                "needed_floor_ms": needed * 32 / PEAK_BYTES_S * 1e3,
                "needed_sectors": needed, "loads": loads}
            for side in order(sides):
                call = lambda: sides[side](st, f, r)
                check_side(sides[side], st, [(f, r)], label + " " + side)
                emit("largest", side, ms=cuda_ms(call, REPS),
                     device_ms=device_ms(call, REPS),
                     cold_ms=reset_ms(scratch.zero_, call, REPS, False)[0],
                     cold_device_ms=reset_ms(scratch.zero_, call, REPS,
                                             True)[0], **counts)


def walk_steps(reads, stamps):
    """(label, fn) of the walks of phases 12 and 12b, their graphs made
    first (12b's last, after 12's is freed)."""
    from khmer_tpu_torch.core import partition as P
    from khmer_tpu_torch.core.sketch import Countgraph
    from khmer_tpu_torch.io.fastx import FastxParser

    dev = torch.device("cuda", torch.cuda.current_device())
    held = {}

    def graph(x, path):
        held.clear()
        torch.cuda.empty_cache()
        g = Countgraph(20, x, 4, device=dev)
        g.set_use_bigcount(True)
        g.consume_seqfile_and_tag(path)
        held["g"] = g
        return g

    seqs = [rec.sequence for _, rec in zip(range(1000), FastxParser(stamps))]
    yield "12 graph", lambda: graph(12.5e6, stamps)
    yield "12 partition", lambda: held["g"].do_subset_partition(
        0, 0, stop_big_traversals=True)
    yield "12 abundance", lambda: held["g"].do_subset_partition_with_abundance(
        *BAND, stop_big_traversals=True)
    for rr in (0, 81):
        yield "12 sweep %d" % rr, lambda rr=rr: P.sweep_for_tags_batch(
            held["g"], seqs, rr)
    yield "12b graph", lambda: graph(1e9, reads)
    yield "12b abundance", lambda: held["g"].do_subset_partition_with_abundance(
        *BAND, stop_big_traversals=True)


def digest(out):
    """A digest of a step's answer: a partition's counts, a sweep's tag
    lists."""
    h = hashlib.sha256()
    if isinstance(out, tuple):
        for tags in out[0]:
            h.update((",".join(str(int(t)) for t in sorted(tags.tolist()))
                      + "\n").encode())
        h.update(str(list(out[1])).encode())
    elif hasattr(out, "count_partitions"):
        h.update(str(out.count_partitions()).encode())
    return h.hexdigest()[:16]


def child(reads, stamps):
    """One side's walls (shape wall), run in a process of its own with its
    checkout first on sys.path: one JSON line a step."""
    from khmer_tpu_torch.core import partition as P
    from khmer_tpu_torch.ops import host

    clocks = {}

    def add(key, v):
        clocks[key] = clocks.get(key, 0.0) + v

    def timed(owner, name, key):
        fn = getattr(owner, name)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                add(key, time.perf_counter() - t0)
        setattr(owner, name, wrapped)

    timed(P, "find_all_tags_batch", "batch_s")
    timed(P, "sweep_for_tags_batch", "batch_s")
    if hasattr(P._Prober, "run"):  # the change: the C++ loop
        from khmer_tpu_torch.scripts.level_tap import add_clocks

        add_clocks(clocks)
        if os.environ.get("NBR_BENCH_OWN_BLOCK") == "1":
            run = P._Prober.run

            def own_block(prober, walk):
                prober.block = None  # the walk's own storage, paged
                return run(prober, walk)
            P._Prober.run = own_block
    else:  # the parent: a level at a time from Python
        timed(P._Prober, "__call__", "probe_s")
        timed(host.TagWalk, "step", "pass_s")
        timed(host.SweepWalk, "step", "pass_s")
    for label, fn in walk_steps(reads, stamps):
        clocks.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({"step": label, "wall_s": wall,
                          "digest": digest(out), "load": os.getloadavg()[0],
                          **clocks}), flush=True)


def walls(parent, reads, tmp, card, emit):
    """Shape wall: each side's child in turns."""
    sides = (("parent", os.path.abspath(parent)), ("change", _REPO),
             ("change-own", _REPO))
    digests = {}

    def run(side, root, timed):
        env = dict(os.environ, PYTHONPATH=root,
                   NBR_BENCH_OWN_BLOCK=str(int(side == "change-own")))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", reads,
             STAMPS], cwd=tmp, env=env, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError("side %s failed:\n%s" % (side, proc.stderr))
        for line in proc.stdout.splitlines():
            rec = json.loads(line)
            key = rec["step"]
            if digests.setdefault(key, rec["digest"]) != rec["digest"]:
                raise AssertionError("%s: the sides' answers differ" % key)
            if timed:
                emit("wall", side, **rec)

    for side, root in sides[:2]:
        run(side, root, False)
    for side, root in sides + sides[::-1] + sides:
        run(side, root, True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", choices=SHAPES,
                    default=list(SHAPES))
    ap.add_argument("--parent", metavar="DIR",
                    help="time the kernel and walk of the checkout at DIR "
                    "in turns")
    ap.add_argument("--child", nargs=2, metavar=("READS", "STAMPS"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("nbr_bench needs a CUDA device")
    if a.child:
        child(*a.child)
        return 0
    from khmer_tpu_torch.ops import cuda
    from khmer_tpu_torch.scripts.synth_reads import write_reads

    card = _card()

    def emit(shape, side, **rec):
        print(json.dumps(dict(shape=shape, side=side, card=card, **rec)),
              flush=True)

    cuda.library()
    parent_fn, report = build_parent(a.parent) if a.parent else (None, [])
    emit("build", "parent", ptxas=report)
    with tempfile.TemporaryDirectory(prefix=".nbr_bench_",
                                     dir=_REPO) as tmp:
        reads = os.path.join(tmp, "synth.fa")
        write_reads(reads)
        if {"levels", "largest"} & set(a.shapes):
            walks = {}
            for label, fn in walk_steps(reads, STAMPS):
                if label.endswith("graph"):
                    fn()
                else:
                    walk = record(fn, tmp)
                    if walk is not None:
                        walks[label] = walk
            sides = callers(parent_fn)
            if "levels" in a.shapes:
                run_levels(walks, sides, card, emit)
            if "largest" in a.shapes:
                run_largest(walks, sides, card, emit)
            del walks
            torch.cuda.empty_cache()
        if "wall" in a.shapes:
            if not a.parent:
                raise SystemExit("shape wall needs --parent")
            walls(a.parent, reads, tmp, card, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
