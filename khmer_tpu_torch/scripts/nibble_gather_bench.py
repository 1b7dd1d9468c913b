#!/usr/bin/env python
"""Kernels R and Q (csrc/nibble_gather.cu) and the torch steps around
them on the --small-count path, on the card, each step timed apart, in
turns with the parent checkout where --parent names one.

Shapes, each taken from the port's CLIs run here as chip_smoke.py's
phases 13 and 13b run them:
  (a) phase 13b's largest normalize window: normalize-by-median -C 20 -x
      2e9 -N 4 --small-count (k 32, 4 x 1 GB of nibble tables) on the
      first 250,000 of synth_reads.py's reads; its first window, 16,384
      rows of 128 codes, against the tables as the run left them (as
      chip_smoke keeps its largest call).
  (b) phase 13's median normalize window: normalize-by-median -C 20 -s
      --small-count on data/stamps-reads.fa.gz (4 x 0.5 MB, in L2), the
      tables as they stood before it.
  (c) phase 13b's abundance-dist-single batches: -k 20 -x 2e9 -N 4
      --small-count on the 1,000,000 reads (batches of 8,192 rows of 128
      codes); every batch's share of valid and of counted events (valid
      and new to the tracking table: the events the histogram reads),
      min / median / max; the first batch (the largest, its tracking
      table empty before it) and the median batch timed.
  (d) a filter-abund-single window at 13b's size: the first 16,384 of the
      reads in rows of 128 against (c)'s tables (k 20, 4 x 1 GB).
  (e) phase 13's largest R call of make-initial-stoptags --small-count
      (load-graph -k 20 -x 12.5e6 -N 4 of the stamps reads, then -x 2e8
      -N 4): R's hashes-in entry, which keeps its design.
  walls: the --small-count CLIs of phases 13 and 13b that take R or Q
      (normalize-by-median, trim-low-abund with and without -V,
      filter-abund-single, abundance-dist-single), a process a side and
      turn, each CLI's wall in process and its outputs' sha256.
  tiles: this tree's rows modes on the code matrices of (a), (b) and (d)
      (those of them that run) at 1 to 64 rows a tile, the tile
      sketch_kernels.read_plan picks among them: device ms hot and cold.

Sides: "parent", the steps as the parent's code took them (hash_windows,
R of the hashes, the pairs' keys by umod, two torch.unique, the copies
back of int32 counters and int64 ids; hash_batch, then Q of every event
or window), on its kernels Q and R built by nvcc from DIR's csrc into
_build/nibble_gather_sides/parent.so; "design", this tree's (R's and Q's
rows modes, Q under the counted mask). For (a)-(d) each step's time by
CUDA events around it (device) and the host's clock (the step ended by a
synchronise), hot and cold (each step after a 100 MB write that flushes
L2, pertable_bench.FLUSH_BYTES), and its kernels' device time by
torch.profiler; the whole step as its caller runs it (the design:
SeqWindow._eval itself, with a count of any torch window hash or umod it
ran, which must be 0; sketch_kernels.abund_batch; the rows mode and its
copy back); and each kernel alone, hot and cold, as issued and the device
alone (pertable_bench.readings); beside the byte bound, the sector floor
of the sectors each side loads (32 B a distinct sector at 3.35 TB/s) and,
for R, torch.take of the flat tables at the valid windows' precomputed
byte indices (the gather alone). Every side's answers are held to this
tree's plain versions. One JSON line a shape, side and turn, the card's
name and power limit in each; the sides in turns (parent, design,
design, parent). Needs a CUDA card; from the repo root:

    python -m khmer_tpu_torch.scripts.nibble_gather_bench [--parent DIR]
        [--shapes a b c d e walls tiles] [--sides parent design]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from khmer_tpu_torch.core import diginorm, pipeline
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops import cuda
from khmer_tpu_torch.ops import hashing as H
from khmer_tpu_torch.ops.u64 import umod
from khmer_tpu_torch.scripts import nibble_update_bench as NB
from khmer_tpu_torch.scripts import pertable_bench as PB

SHAPES = ("a", "b", "c", "d", "e", "walls", "tiles")
# rows a tile that "tiles" times the rows modes at
TILE_ROWS = (1, 2, 4, 8, 16, 32, 64)
SIDES = ("parent", "design")
PEAK_BYTES_S = NB.PEAK_BYTES_S
REPS = 5
_REPO = NB._REPO
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# the parent's khmer_nibble_gather and khmer_nibble_pertable: flat,
# ntables, primes (host), nibble offsets (host), hashes, n, out, device,
# stream
PARENT_ARGTYPES = [_P, _I32, _P, _P, _P, _I64, _P, _I32, _P]


class ParentKernels:
    """The parent's Q and R, built by nvcc from DIR's csrc into
    _build/nibble_gather_sides/parent.so, called as its wrappers called
    them."""

    def __init__(self, parent):
        out_dir = os.path.join(cuda.BUILD_DIR, "nibble_gather_sides")
        os.makedirs(out_dir, exist_ok=True)
        csrc = os.path.join(os.path.abspath(parent), "khmer_tpu_torch",
                            "csrc")
        lib = os.path.join(out_dir, "parent.so")
        proc = subprocess.run(
            [cuda._nvcc()] + cuda.ARCH_FLAGS
            + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
               "-Xptxas", "-v", "-I", csrc, "-o", lib,
               os.path.join(csrc, "nibble_gather.cu")],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError("nvcc failed on the parent:\n" + proc.stderr)
        self.ptxas = NB._ptxas(proc.stderr)
        self.lib = ctypes.CDLL(lib)
        for name in ("khmer_nibble_gather", "khmer_nibble_pertable"):
            fn = getattr(self.lib, name)
            fn.argtypes = PARENT_ARGTYPES
            fn.restype = ctypes.c_int

    def _call(self, name, primes, flat, hashes, out):
        primes_arr, offsets_arr = K._layout(primes, nibbles=True)
        dev = flat.device
        cuda.check(getattr(self.lib, name)(
            flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
            ctypes.addressof(offsets_arr), hashes.data_ptr(),
            hashes.shape[0], out.data_ptr(), dev.index, K._stream(dev)),
            "parent " + name)
        return out

    def gather(self, primes, flat, hashes):
        return self._call("khmer_nibble_gather", primes, flat, hashes,
                          torch.empty(hashes.shape[0], dtype=torch.int32,
                                      device=flat.device))

    def pertable(self, primes, flat, hashes):
        return self._call("khmer_nibble_pertable", primes, flat, hashes,
                          torch.empty((len(primes), hashes.shape[0]),
                                      dtype=torch.uint8,
                                      device=flat.device))


# -- the shapes' inputs, captured from the CLIs -------------------------------


def capture_windows(main, args, cwd, clone):
    """Run a CLI here and keep each SeqWindow's inputs: [(primes, k, the
    tables' flat buffer (a copy as it stood when `clone`, else the live
    buffer), seqs)]."""
    fn = diginorm.SeqWindow._eval
    calls = []

    def keep(self, seqs):
        flat = self.graph.tables.flat
        calls.append((self._primes, self.k,
                      flat.clone() if clone else flat, list(seqs)))
        return fn(self, seqs)

    diginorm.SeqWindow._eval = keep
    try:
        NB._run(main, args, cwd)
    finally:
        diginorm.SeqWindow._eval = fn
    return calls


def capture_batches(main, args, cwd):
    """Run abundance-dist-single here and keep each batch: [(codes,
    lengths, k, valid, counted)], the main tables (primes, NibbleTables)
    and the tracking tables (primes, BitTables) as the run left them."""
    hash_batch, abund_batch = pipeline.hash_batch, K.abund_batch
    batches, tables = [], {}

    def keep_hash(codes, lengths, k):
        batches.append([codes.clone(), lengths.clone(), k])
        return hash_batch(codes, lengths, k)

    def keep_abund(track_kind, track_primes, track_tables, main_kind,
                   main_primes, main_tables, hashes, valid):
        b = abund_batch(track_kind, track_primes, track_tables, main_kind,
                        main_primes, main_tables, hashes, valid)
        batches[-1] += [valid.clone(), b["counted"].clone()]
        tables["main"] = (main_primes, main_tables)
        tables["track"] = (track_primes, track_tables)
        return b

    pipeline.hash_batch, K.abund_batch = keep_hash, keep_abund
    try:
        NB._run(main, args, cwd)
    finally:
        pipeline.hash_batch, K.abund_batch = hash_batch, abund_batch
    return batches, tables["main"], tables["track"]


def capture_pertable(main, args, cwd):
    """Run a CLI here and keep its largest R call (hashes-in):
    (primes, the live tables' flat buffer, its hashes)."""
    fn = K.nibble_pertable
    largest = []

    def keep(primes, flat, hashes):
        if not largest or hashes.numel() > largest[0][2].numel():
            largest[:] = [(tuple(primes), flat, hashes.clone())]
        return fn(primes, flat, hashes)

    K.nibble_pertable = keep
    try:
        NB._run(main, args, cwd)
    finally:
        K.nibble_pertable = fn
    return largest[0]


def write_synth(tmp):
    """(the 1,000,000 reads, their first 250,000) written in tmp."""
    from khmer_tpu_torch.scripts.synth_reads import write_reads

    reads = os.path.join(tmp, "synth.fa")
    write_reads(reads)
    head = os.path.join(tmp, "synth-head.fa")
    with open(reads, "rb") as src, open(head, "wb") as dst:
        for _ in range(2 * NB.HEAD_READS):
            dst.write(src.readline())
    return reads, head


def first_reads(path, n):
    """The first n sequences of a FASTA file of one line a sequence."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.startswith(">"):
                out.append(line.strip())
                if len(out) == n:
                    break
    return out


# -- counts, bounds and readings ----------------------------------------------


def sectors(primes, hashes):
    """(distinct 32-byte sectors, distinct bytes) of the nibble tables
    holding the counters of `hashes` (1-D)."""
    byte = torch.cat([(umod(hashes, p) + 2 * off) >> 1 for p, off in zip(
        primes, K.nibble_offsets(primes))]).unique()
    return int((byte >> 5).unique().numel()), int(byte.numel())


def loads(primes, hashes):
    """Sectors, the sector floor in ms and the distinct bytes of the
    counters of `hashes`."""
    s, b = sectors(primes, hashes)
    return {"sectors": s, "floor_ms": NB.SECTOR * s / PEAK_BYTES_S * 1e3,
            "distinct_bytes": b}


def bound_ms(nbytes):
    return nbytes / PEAK_BYTES_S * 1e3


def kernel_readings(fn, flush, lookups):
    rec = PB.readings(fn, flush, lookups)
    return {k: rec[k] for k in ("ms", "device_ms", "cold_ms",
                                "cold_device_ms", "lookups_s")}


def step_split(steps, flush, reps=REPS):
    """{step: {"device_ms", "host_ms", "cold_device_ms", "cold_host_ms",
    "kernel_ms", "kernels", "copy_ms"}} of a sequence of (name, fn) run in
    order `reps` times hot and `reps` times cold (flush() before each
    step, outside its clocks): CUDA events around each step and the host's
    clock to the synchronise after it; then one profiled run, each step's
    kernels' device time and count and its copies' device time
    (torch.profiler)."""
    from torch.autograd import DeviceType

    out = {name: {"device_ms": 0.0, "host_ms": 0.0, "cold_device_ms": 0.0,
                  "cold_host_ms": 0.0} for name, _ in steps}
    for cold in (False, True):
        for _ in range(reps):
            for name, fn in steps:
                if cold:
                    flush()
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                fn()
                e1.record()
                torch.cuda.synchronize()
                pre = "cold_" if cold else ""
                out[name][pre + "host_ms"] += (time.perf_counter()
                                               - t0) * 1e3 / reps
                out[name][pre + "device_ms"] += e0.elapsed_time(e1) / reps
    for name, fn in steps:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = copy = 0.0
        count = 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.count == 0:
                continue
            us = NB._self_device_us(e)
            if "Memcpy" in e.key or "Memset" in e.key:
                copy += us
            else:
                kern += us
                count += e.count
        out[name].update(kernel_ms=kern / 1e3, kernels=count,
                         copy_ms=copy / 1e3)
    return {k: {n: round(v, 5) if isinstance(v, float) else v
                for n, v in d.items()} for k, d in out.items()}


def whole_ms(fn, flush, reps=REPS):
    """Host ms of fn() (which ends in a copy to the host), hot and after
    flush()."""
    out = {}
    for cold in (False, True):
        total = 0.0
        for _ in range(reps):
            if cold:
                flush()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
        out["cold_ms" if cold else "ms"] = total * 1e3 / reps
    return out


class Counted:
    """Counts the calls of module functions while installed (the torch
    window hashes and umod that the design's window step must not run)."""

    NAMES = ((H, "hash_windows"), (H, "rolling_hash_windows"),
             (K, "rolling_hash_windows"), (diginorm, "umod"),
             (K, "umod"))

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        self.saved = []
        for mod, name in self.NAMES:
            fn = getattr(mod, name)
            key = "%s.%s" % (mod.__name__.rsplit(".", 1)[-1], name)
            self.calls[key] = 0

            def counting(*a, _fn=fn, _key=key, **kw):
                self.calls[_key] += 1
                return _fn(*a, **kw)

            setattr(mod, name, counting)
            self.saved.append((mod, name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


# -- the window step: shapes (a) and (b) --------------------------------------


def encode(seqs, k, dev):
    """The parent's SeqWindow._eval rows, a read at a time: codes [B, L]
    and lengths [B] on `dev`."""
    longest = max(len(s) for s in seqs)
    L = max(pipeline._bucket_len(longest), longest, k + 1)
    B = pipeline._bucket_rows(len(seqs))
    codes = np.zeros((B, L), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs):
        c = H.encode_dna(s)
        codes[i, :len(c)] = c
        lengths[i] = len(c)
    return (torch.from_numpy(codes).to(dev),
            torch.from_numpy(lengths).to(dev))


def window_steps(side, parent, primes, flat, k, seqs):
    """(steps, state) of the window step on a side: the parent's _eval as
    its code took it, or this tree's, split into steps."""
    T = len(primes)
    dev = flat.device
    st = {}

    def enc():
        if side == "parent":
            st["codes"], st["lengths"] = encode(seqs, k, dev)
        else:
            codes, lengths = diginorm.window_rows(seqs, k)
            st["codes"] = torch.from_numpy(codes).to(dev)
            st["lengths"] = torch.from_numpy(lengths).to(dev)

    def unique_pairs():
        st["ids"] = torch.unique(st["keys"], return_inverse=True)[1]

    def repeats():
        ids, B = st["ids"], st["codes"].shape[0]
        npairs = int(ids.max()) + 1
        row = torch.arange(B, device=dev)[None, :, None]
        seen, n = torch.unique((row * npairs + ids)[
            st["valid"].expand_as(ids)], return_counts=True)
        rep = torch.zeros(B, dtype=torch.bool, device=dev)
        rep[seen[n > 1] // npairs] = True
        st["repeats"] = rep

    def copy(key, dtype=None):
        def fn():
            t = st[key] if dtype is None else st[key].to(dtype)
            st["host_" + key] = t.cpu().numpy()
        return fn

    if side == "parent":
        def hash_():
            codes, lengths = st["codes"], st["lengths"]
            W = codes.shape[1] - k + 1
            st["hashes"] = H.hash_windows(codes, k, "twobit")
            win = torch.arange(W, device=dev)[None, :]
            st["valid"] = win <= (lengths.to(torch.int64)[:, None] - k)

        def r():
            h = st["hashes"]
            st["per"] = parent.pertable(primes, flat, h.reshape(-1)).reshape(
                T, *h.shape).to(torch.int32)

        def keys():
            st["keys"] = torch.stack([umod(st["hashes"], p) * T + t
                                      for t, p in enumerate(primes)])

        steps = [("encode", enc), ("hash_windows", hash_), ("R", r),
                 ("umod_keys", keys), ("unique_pairs", unique_pairs),
                 ("unique_repeats", repeats), ("copy_hashes",
                                               copy("hashes")),
                 ("copy_counters", copy("per")), ("copy_ids", copy("ids")),
                 ("copy_repeats", copy("repeats"))]
    else:
        def r():
            st["hashes"], st["per"], st["keys"] = \
                K.nibble_pertable_rows_cuda(primes, flat, st["codes"],
                                            st["lengths"], k)
            st["valid"] = st["keys"][0] >= 0

        steps = [("encode", enc), ("R_rows", r),
                 ("unique_pairs", unique_pairs),
                 ("unique_repeats", repeats),
                 ("copy_hashes", copy("hashes")),
                 ("copy_counters", copy("per")),
                 ("copy_ids", copy("ids", torch.int32)),
                 ("copy_repeats", copy("repeats"))]
    return steps, st


def window_whole(side, parent, primes, flat, k, seqs):
    """fn() of the whole window step as its caller runs it: the parent's
    steps back to back; this tree's SeqWindow._eval itself."""
    if side == "parent":
        steps, _ = window_steps(side, parent, primes, flat, k, seqs)
        return lambda: [fn() for _, fn in steps]
    graph = type("Graph", (), {})()
    graph.storage_kind, graph.hash_family = "nibble", "twobit"
    graph.device, graph.tables = flat.device, type("T", (), {"flat": flat})
    win = object.__new__(diginorm.SeqWindow)
    win.graph, win.k, win._primes = graph, k, primes
    return lambda: win._eval(seqs)


def check_window(st, primes, flat, k):
    """Hold a side's window outputs to nibble_pertable_rows_plain on the
    valid windows: hashes, counters and repeats; returns the valid share
    and its hashes."""
    h, per, idx = K.nibble_pertable_rows_plain(primes, flat, st["codes"],
                                               st["lengths"], k)
    valid = idx[0] >= 0
    ok = (torch.equal(st["hashes"][valid], h[valid])
          and torch.equal(st["per"][:, valid].to(torch.uint8),
                          per[:, valid]))
    if not ok:
        raise AssertionError("a side's window differs from plain")
    return valid, h


def run_window(shape, sides, parent, primes, flat, k, seqs, flush, card,
               extra):
    """Shape (a) or (b) on each side in turns: one JSON line each."""
    codes, lengths = encode(seqs, k, flat.device)
    hashes, per, idx = K.nibble_pertable_rows_plain(primes, flat, codes,
                                                    lengths, k)
    valid = idx[0] >= 0
    B, W = valid.shape
    T = len(primes)
    n_all, n_valid = B * W, int(valid.sum())
    # the parent hashed and gathered every window, past a read's end too
    flat_h = H.hash_windows(codes, k, "twobit").reshape(-1).contiguous()
    all_loads = loads(primes, flat_h)
    valid_loads = loads(primes, hashes[valid])
    idx_v = torch.cat([(umod(hashes[valid], p) + 2 * off) >> 1
                       for p, off in zip(primes, K.nibble_offsets(primes))])
    take = kernel_readings(lambda: torch.take(flat, idx_v), flush,
                           T * n_valid)
    del idx_v, per, idx
    counts = dict(extra, rows=B, L=int(codes.shape[1]), k=k, tables=T,
                  table_bytes=int(flat.shape[0]), windows=n_all,
                  valid_windows=n_valid, valid_share=n_valid / n_all,
                  take_valid=take)
    for side in sides + sides[::-1]:
        steps, st = window_steps(side, parent, primes, flat, k, seqs)
        for _, fn in steps:
            fn()
        check_window(st, primes, flat, k)
        split = step_split(steps, flush)
        whole = whole_ms(window_whole(side, parent, primes, flat, k, seqs),
                         flush)
        rec = {"split": split, "whole": whole}
        if side == "parent":
            rec["kernel"] = kernel_readings(
                lambda: parent.pertable(primes, flat, flat_h), flush,
                T * n_all)
            rec["loads"] = all_loads
            rec["bound_ms"] = bound_ms(8 * n_all + T * n_all
                                       + all_loads["distinct_bytes"])
        else:
            c, n = st["codes"], st["lengths"]
            rec["kernel"] = kernel_readings(
                lambda: K.nibble_pertable_rows_cuda(primes, flat, c, n, k),
                flush, T * n_valid)
            rec["loads"] = valid_loads
            rec["bound_ms"] = bound_ms(c.numel() + 4 * n.numel()
                                       + (8 + 9 * T) * n_all
                                       + valid_loads["distinct_bytes"])
            with Counted() as counted:
                window_whole(side, parent, primes, flat, k, seqs)()
                torch.cuda.synchronize()
            rec["torch_hash_and_umod_calls"] = counted.calls
            if any(counted.calls.values()):
                raise AssertionError("the design's window step ran %s"
                                     % counted.calls)
        print(json.dumps(dict(shape=shape, side=side, card=card, **counts,
                              **rec)), flush=True)


def run_tiles(label, primes, flat, codes, lengths, k, flush, card):
    """R's and Q's rows modes on a code matrix at each rows a tile of
    TILE_ROWS that a block's shared memory holds (read_plan's segment),
    each held to the wrappers' outputs: device ms hot and cold."""
    R, L = codes.shape
    W, T = L - k + 1, len(primes)
    seg = K.read_plan(L, k)["seg"]
    primes_arr, offsets_arr = K._layout(primes, nibbles=True)
    dev = flat.device
    wants = {"khmer_nibble_pertable_rows": K.nibble_pertable_rows_cuda(
        primes, flat, codes, lengths, k),
        "khmer_nibble_row_counts": (K.nibble_row_counts_cuda(
            primes, flat, codes, lengths, k),)}
    rec = {}
    for name, want in wants.items():
        out = tuple(torch.empty_like(t) for t in want)
        fn = getattr(cuda.library(), name)
        for rows in TILE_ROWS:
            if rows * (16 * (seg // 32 + 1) + seg) > K.READ_SMEM_LIMIT:
                continue

            def call():
                cuda.check(fn(
                    flat.data_ptr(), T, ctypes.addressof(primes_arr),
                    ctypes.addressof(offsets_arr), codes.data_ptr(),
                    lengths.data_ptr(), R, L, k, rows, seg,
                    *[t.data_ptr() for t in out], dev.index,
                    K._stream(dev)), name)
            call()
            if not all(torch.equal(a, b) for a, b in zip(out, want)):
                raise AssertionError("%s differs at %d rows a tile"
                                     % (name, rows))
            m = PB.readings(call, flush, T * R * W)
            rec.setdefault(name, {})[rows] = {
                "device_ms": m["device_ms"],
                "cold_device_ms": m["cold_device_ms"]}
    print(json.dumps({"shape": label + " tiles", "card": card, "L": L,
                      "k": k, "seg": seg,
                      "plan_rows": K.read_plan(L, k)["rows"], **rec}),
          flush=True)


# -- the abundance batch: shape (c) -------------------------------------------


def batch_shares(batches):
    """min / median / max of every batch's valid and counted shares."""
    v = np.array([float(b[3].float().mean()) for b in batches])
    c = np.array([float(b[4].float().mean()) for b in batches])
    q = lambda a: [float(a.min()), float(np.median(a)), float(a.max())]
    return {"batches": len(batches), "valid_share": q(v),
            "counted_share": q(c)}


def run_batch(label, sides, parent, batch, main, track, flush, card,
              extra, time_j):
    """One abundance batch on each side in turns: hash_batch, J (where
    time_j: the tracking table zeroed, the state before the first batch)
    and Q apart, and the batch's step up to its histogram index
    (abund_batch); Q's loads on each side."""
    codes, lengths, k, valid, counted = batch
    primes, tables = main
    tprimes, ttables = track
    flat = tables.flat
    hashes = pipeline.hash_batch(codes, lengths, k)[0].reshape(-1)
    n = hashes.numel()
    T = len(primes)
    want = K.nibble_gather_plain(primes, flat, hashes, counted)
    base = dict(extra, batch=label, events=n,
                valid_share=float(valid.float().mean()),
                counted_share=float(counted.float().mean()),
                counted_events=int(counted.sum()))
    all_loads = loads(primes, hashes)
    counted_loads = loads(primes, hashes[counted])
    for side in sides + sides[::-1]:
        if side == "parent":
            q = lambda: parent.gather(primes, flat, hashes)
            got = torch.where(counted, q(), 0)
            rec = {"loads": all_loads,
                   "bound_ms": bound_ms(12 * n
                                        + all_loads["distinct_bytes"])}
        else:
            q = lambda: K.nibble_gather_cuda(primes, flat, hashes, counted)
            got = q()
            rec = {"loads": counted_loads,
                   "bound_ms": bound_ms(13 * n
                                        + counted_loads["distinct_bytes"])}
        if not torch.equal(got, want):
            raise AssertionError("side %s: Q differs from plain" % side)
        rec["Q"] = kernel_readings(q, flush, T * n)
        steps = [("hash_batch", lambda: pipeline.hash_batch(codes, lengths,
                                                            k)),
                 ("Q", q)]
        if time_j:
            zero = ttables.flat.zero_

            def j():
                K.bit_update(tprimes, ttables, torch.zeros(
                    1, dtype=torch.int64, device=flat.device), hashes, n,
                    valid)
            steps[1:1] = [("zero_tracking", zero), ("J", j)]

            def step():
                if side == "parent":
                    c = K.bit_update(tprimes, ttables, torch.zeros(
                        1, dtype=torch.int64, device=flat.device), hashes,
                        n, valid)
                    cnt = parent.gather(primes, flat, hashes).to(
                        torch.int64)
                    return torch.where(c & (cnt != K.MAX_KCOUNT), cnt,
                                       K.ABUND_BINS)
                return K.abund_batch("bit", tprimes, ttables, "nibble",
                                     primes, tables, hashes, valid)["idx"]
            rec["batch_step_ms"] = NB.reset_ms(zero, step, REPS, False)[0]
            rec["batch_step_device_ms"] = NB.reset_ms(zero, step, REPS,
                                                      True)[0]
        rec["split"] = step_split(steps, flush)
        print(json.dumps(dict(shape="c", side=side, card=card, **base,
                              **rec)), flush=True)


# -- the filter window: shape (d) ---------------------------------------------


def run_rows(sides, parent, primes, flat, codes, lengths, k, flush, card,
             extra):
    """(d) on each side in turns: the parent's hash_batch, Q of every
    window and its int32 copy back against Q's rows mode and its uint8
    copy back."""
    hashes, valid = pipeline.hash_batch(codes, lengths, k)
    B, W = valid.shape
    T = len(primes)
    want = K.nibble_row_counts_plain(primes, flat, codes, lengths, k)
    all_loads = loads(primes, hashes.reshape(-1))
    valid_loads = loads(primes, hashes[valid])
    base = dict(extra, rows=B, L=int(codes.shape[1]), k=k, windows=B * W,
                valid_windows=int(valid.sum()),
                valid_share=float(valid.float().mean()))
    for side in sides + sides[::-1]:
        st = {}
        if side == "parent":
            def h():
                st["h"] = pipeline.hash_batch(codes, lengths, k)[0]

            def q():
                st["c"] = parent.gather(primes, flat, st["h"].reshape(
                    -1)).reshape(B, W)
            steps = [("hash_batch", h), ("Q", q)]
            rec = {"loads": all_loads, "bound_ms": bound_ms(
                12 * B * W + all_loads["distinct_bytes"])}
        else:
            def q():
                st["c"] = K.nibble_row_counts_cuda(primes, flat, codes,
                                                   lengths, k)
            steps = [("Q_rows", q)]
            rec = {"loads": valid_loads, "bound_ms": bound_ms(
                codes.numel() + 4 * B + B * W
                + valid_loads["distinct_bytes"])}
        steps.append(("copy_counts",
                      lambda: st.__setitem__("host", st["c"].cpu().numpy())))
        for _, fn in steps:
            fn()
        if not torch.equal(torch.where(valid, st["c"], 0).to(torch.uint8),
                           want):
            raise AssertionError("side %s: the window differs from plain"
                                 % side)
        rec["split"] = step_split(steps, flush)
        rec["whole"] = whole_ms(lambda: [fn() for _, fn in steps], flush)
        rec["kernel"] = kernel_readings(steps[-2][1], flush, T * B * W)
        print(json.dumps(dict(shape="d", side=side, card=card, **base,
                              **rec)), flush=True)


# -- the knots' R call: shape (e) ---------------------------------------------


def run_pertable(sides, parent, call, flush, card):
    primes, flat, hashes = call
    n, T = hashes.numel(), len(primes)
    want = K.nibble_pertable_plain(primes, flat, hashes)
    ld = loads(primes, hashes)
    for side in sides + sides[::-1]:
        fn = ((lambda: parent.pertable(primes, flat, hashes))
              if side == "parent"
              else (lambda: K.nibble_pertable_cuda(primes, flat, hashes)))
        if not torch.equal(fn(), want):
            raise AssertionError("side %s: R differs from plain" % side)
        print(json.dumps(dict(
            shape="e", side=side, card=card, hashes=n, tables=T,
            table_bytes=int(flat.shape[0]), loads=ld,
            bound_ms=bound_ms(8 * n + T * n + ld["distinct_bytes"]),
            kernel=kernel_readings(fn, flush, T * n))), flush=True)


# -- the walls ----------------------------------------------------------------

# run in a process of its own from a side's root: each CLI's wall in
# process (the card synchronised after it) and its outputs' sha256
_WALLS_DRIVER = r"""
import contextlib, hashlib, io, json, os, sys, tempfile, time
import torch
from khmer_tpu_torch.ops import cuda
from khmer_tpu_torch.cli import (abundance_dist_single, filter_abund_single,
                                 normalize_by_median, trim_low_abund)
cuda.library()
runs = json.loads(sys.argv[1])
mods = {"normalize-by-median": normalize_by_median,
        "trim-low-abund": trim_low_abund,
        "filter-abund-single": filter_abund_single,
        "abundance-dist-single": abundance_dist_single}
out = {}
with tempfile.TemporaryDirectory(dir=sys.argv[2]) as tmp:
    for label, cli, args, files in runs:
        d = os.path.join(tmp, label.replace(" ", "_"))
        os.makedirs(d)
        os.chdir(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            mods[cli].main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        shas = [hashlib.sha256(open(f, "rb").read()).hexdigest()[:16]
                for f in files]
        out[label] = [wall, shas]
print(json.dumps(out))
"""


def wall_runs(reads, head):
    """(label, CLI, args, output files) of the walls' CLIs."""
    stamps, data = NB.STAMPS, NB.DATA
    t13 = ["-k", "20", "-x", "5e7", "-N", "4", "--small-count"]
    base = os.path.basename
    return [
        ("13 normalize-by-median", "normalize-by-median",
         ["-C", "20", "-s", "n.ct", "--small-count", stamps],
         [base(stamps) + ".keep", "n.ct"]),
        ("13 trim-low-abund", "trim-low-abund",
         t13[:6] + ["-C", "2", "-s", "t.ct", "--small-count", stamps],
         [base(stamps) + ".abundtrim", "t.ct"]),
        ("13 trim-low-abund -V", "trim-low-abund",
         t13[:6] + ["-C", "2", "-s", "t.ct", "--small-count", "-V",
                    stamps], [base(stamps) + ".abundtrim"]),
        ("13 filter-abund-single", "filter-abund-single",
         ["-k", "20", "-x", "5e7", "-C", "2", "--small-count", data],
         [base(data) + ".abundfilt"]),
        ("13 abundance-dist-single", "abundance-dist-single",
         t13 + [data, "s.dist"], ["s.dist"]),
        ("13b abundance-dist-single", "abundance-dist-single",
         ["-k", "20", "-x", "2e9", "-N", "4", "--small-count", reads,
          "s.dist"], ["s.dist"]),
        ("13b normalize-by-median", "normalize-by-median",
         ["-C", "20", "-x", "2e9", "-N", "4", "--small-count", head],
         [base(head) + ".keep"]),
        ("13b filter-abund-single", "filter-abund-single",
         ["-k", "20", "-x", "2e9", "-N", "4", "-C", "2", "--small-count",
          head], [base(head) + ".abundfilt"])]


def run_walls(sides, roots, reads, head, tmp, card):
    runs = json.dumps(wall_runs(reads, head))
    for turn, side in enumerate(sides + sides[::-1]):
        env = dict(os.environ, PYTHONPATH=roots[side])
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _WALLS_DRIVER, runs,
                               tmp], cwd=roots[side], env=env,
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError("walls on side %s:\n%s" % (side,
                                                          proc.stderr))
        print(json.dumps({"shape": "walls", "side": side, "turn": turn,
                          "card": card, "process_s":
                          time.perf_counter() - t0,
                          "walls": json.loads(
                              proc.stdout.strip().splitlines()[-1])}),
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", choices=SHAPES,
                    default=list(SHAPES))
    ap.add_argument("--sides", nargs="+", choices=SIDES,
                    default=list(SIDES))
    ap.add_argument("--parent", metavar="DIR",
                    help="the parent checkout, timed in turns")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("nibble_gather_bench needs a CUDA device")
    if "parent" in a.sides and not a.parent:
        raise SystemExit("side parent needs --parent DIR")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = "%s [%s]" % (torch.cuda.get_device_name(dev), subprocess.run(
        ["nvidia-smi", "-i", str(dev.index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    cuda.library()
    parent = ParentKernels(a.parent) if "parent" in a.sides else None
    print(json.dumps({"card": card, "parent_ptxas": parent and parent.ptxas}),
          flush=True)
    sides = list(a.sides)
    flush_buf = torch.empty(PB.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    from khmer_tpu_torch.cli import (abundance_dist_single, load_graph,
                                     make_initial_stoptags,
                                     normalize_by_median)

    with tempfile.TemporaryDirectory(prefix=".nibble_gather_bench_",
                                     dir=_REPO) as tmp:
        reads = head = None
        if {"a", "c", "d", "walls"} & set(a.shapes):
            reads, head = write_synth(tmp)
        if "a" in a.shapes:
            t0 = time.perf_counter()
            calls = capture_windows(normalize_by_median.main, [
                "-C", "20", "-x", "2e9", "-N", "4", "--small-count", head],
                tempfile.mkdtemp(dir=tmp), clone=False)
            primes, k, flat, seqs = max(calls, key=lambda c: len(c[3]))
            run_window("a", sides, parent, primes, flat, k, seqs, flush,
                       card, {"windows_in_run": len(calls),
                              "setup_s": time.perf_counter() - t0})
            if "tiles" in a.shapes:
                run_tiles("a", primes, flat, *encode(seqs, k, dev), k,
                          flush, card)
            del calls, flat
            torch.cuda.empty_cache()
        if "b" in a.shapes:
            calls = capture_windows(normalize_by_median.main, [
                "-C", "20", "-s", "n.ct", "--small-count", NB.STAMPS],
                tempfile.mkdtemp(dir=tmp), clone=True)
            primes, k, flat, seqs = sorted(
                calls, key=lambda c: len(c[3]))[(len(calls) - 1) // 2]
            run_window("b", sides, parent, primes, flat, k, seqs, flush,
                       card, {"windows_in_run": len(calls)})
            if "tiles" in a.shapes:
                run_tiles("b", primes, flat, *encode(seqs, k, dev), k,
                          flush, card)
            del calls
        if {"c", "d"} & set(a.shapes):
            batches, main_t, track = capture_batches(
                abundance_dist_single.main,
                ["-k", "20", "-x", "2e9", "-N", "4", "--small-count", reads,
                 "s.dist"], tempfile.mkdtemp(dir=tmp))
            if "c" in a.shapes:
                extra = batch_shares(batches)
                print(json.dumps(dict(shape="c", card=card, **extra)),
                      flush=True)
                run_batch("first", sides, parent, batches[0], main_t, track,
                          flush, card, {}, time_j=True)
                run_batch("median", sides, parent,
                          batches[(len(batches) - 1) // 2], main_t, track,
                          flush, card, {}, time_j=False)
            if "d" in a.shapes:
                from khmer_tpu_torch.core.diginorm_scan import pack_reads

                codes, lengths = pack_reads(first_reads(reads, 16384), 128)
                codes = torch.from_numpy(codes).to(dev)
                lengths = torch.from_numpy(lengths).to(dev)
                run_rows(sides, parent, main_t[0], main_t[1].flat, codes,
                         lengths, 20, flush, card,
                         {"tables": len(main_t[0]),
                          "table_bytes": int(main_t[1].flat.shape[0])})
                if "tiles" in a.shapes:
                    run_tiles("d", main_t[0], main_t[1].flat, codes,
                              lengths, 20, flush, card)
            del batches, main_t, track
            torch.cuda.empty_cache()
        if "e" in a.shapes:
            cwd = tempfile.mkdtemp(dir=tmp)
            NB._run(load_graph.main, ["-k", "20", "-x", "12.5e6", "-N", "4",
                                      "g", NB.STAMPS], cwd)
            run_pertable(sides, parent, capture_pertable(
                make_initial_stoptags.main, ["-k", "20", "-x", "2e8", "-N",
                                             "4", "--small-count", "g"],
                cwd), flush, card)
        if "walls" in a.shapes:
            roots = {"design": _REPO}
            if parent is not None:
                roots["parent"] = os.path.abspath(a.parent)
            run_walls(sides, roots, reads, head, tmp, card)


if __name__ == "__main__":
    sys.exit(main())
