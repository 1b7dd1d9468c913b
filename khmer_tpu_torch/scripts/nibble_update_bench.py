#!/usr/bin/env python
"""Kernel P (csrc/nibble_update.cu khmer_nibble_update) on its shapes, on
the card, each of its passes timed apart, in turns with the parent
checkout's kernel where --parent names one.

Shapes:
  (a) chip_smoke phase 13b's largest P call: normalize-by-median -C 20 -x
      2e9 -N 4 --small-count on the first 250,000 of synth_reads.py's
      reads (a window's commit into 4 x 1 GB of nibble tables), run here;
      the tables zeroed before each call.
  (b) a 2^20-event dense chunk: the first P call of load-into-counting -k
      20 -x 5e7 -N 4 --small-count on data/25k.fq.gz (4 x 25 MB, beyond
      L2), the tables zeroed before each call.
  (c) one hash 2^20 times into 4 tables near 1e5 (nibble_cases'
      "one-hash-x2^20"), zeroed before each call: the skew case.
  (d) the median-size P call of normalize-by-median -C 20 --small-count on
      data/stamps-reads.fa.gz (phase 13's command), the tables restored
      before each call to what they held before it.
Each side and shape: the call as issued and the device alone
(scripts.reset_ms, the reset outside the events), and each pass's device
time a call from torch.profiler (parent: the memsets, count, scan,
scatter, bucket, finalize; this tree: the memset, count, scatter,
bucket); beside the bytes bound (8 B a hash, each distinct table byte read
and written), the sector floor (32 B a distinct sector read and written,
at 3.35 TB/s), the time two library calls take to read and write back
each distinct word the call touches (torch.take, index_put_), the scratch
bytes and the buckets. Every side's tables,
n_unique and new flags are held to nibble_update_plain on every shape.

Sides: "parent", DIR/khmer_tpu_torch/csrc/nibble_update.cu and its
headers built by nvcc into _build/nibble_sides/ and called with the
parent's scratch (update_plan); "design", this tree's kernel as
nibble_update_cuda calls it. They run in turns (parent, design, design,
parent) in one process on the same tensors. One JSON line a shape and
side, the card's name and power limit in each. With --clocks, this
tree's kernel is also built with KHMER_NIBBLE_CLOCKS (thread 0 of each
block adds each phase's cycles, read after a barrier) and each shape
prints the mean cycles a block of each phase of the count, scatter and
bucket passes. Needs a CUDA card; from the repo root:

    python -m khmer_tpu_torch.scripts.nibble_update_bench [--parent DIR]
        [--shapes a b c d] [--sides parent design] [--clocks]
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

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops import cuda
from khmer_tpu_torch.scripts import reset_ms

SHAPES = ("a", "b", "c", "d")
SIDES = ("parent", "design")
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
SECTOR = 32
REPS = 20
SPLIT_REPS = 10
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(_REPO, "data", "25k.fq.gz")
STAMPS = os.path.join(_REPO, "data", "stamps-reads.fa.gz")
HEAD_READS = 250_000  # chip_smoke.TRACED_READS
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# the parent's khmer_nibble_update: flat, size, ntables, primes (host),
# nibble offsets (host), hashes, nvalid, nbuckets, ids, start, cursor,
# ev_word, flags, n_unique, device, stream (update_plan's scratch)
PARENT_ARGTYPES = [_P, _I64, _I32, _P, _P, _P, _I64, _I32, _P, _P, _P, _P,
                   _P, _P, _I32, _P]
# each pass's kernel, by what its name holds (in order; first match
# wins), and its launches a call
STEPS = {"parent": (("memsets", "Memset", 2),
                    ("count", "tile_kernel<", 1),  # ", true>": scatter
                    ("scan", "scan_kernel", 1),
                    ("bucket", "bucket_kernel", 1),
                    ("finalize", "finalize_kernel", 1)),
         "design": (("memsets", "Memset", 1),
                    ("count", "nib_count_kernel", 1),
                    ("scatter", "nib_scatter_kernel", 1),
                    ("bucket", "nib_bucket_kernel", 1))}


def _self_device_us(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def step_of(side, name):
    """(pass, launches a call) of kernel `name` on `side`, or None (the
    reset's copy)."""
    for step, part, per_call in STEPS[side]:
        if part in name:
            if step == "count" and side == "parent" and ", true>" in name:
                return "scatter", 1
            return step, per_call
    return None


def pass_split(side, reset, fn, reps=SPLIT_REPS):
    """{pass: device ms a call} of fn() from torch.profiler over `reps`
    calls, each after reset() (its copy left out): each pass's mean time a
    launch times its launches a call, so a trace that lost some events
    still gives a call's split; "total", their sum; "seen", the share of
    the expected launches the trace kept; anything else the device ran
    under "other"."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            reset()
            fn()
        torch.cuda.synchronize()
    split, launches, other = {}, {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.count == 0:
            continue
        found = step_of(side, e.key)
        if found is None:
            if "Memcpy" not in e.key:
                other[e.key[:60]] = round(_self_device_us(e) / reps / 1e3, 5)
            continue
        step, per_call = found
        split[step] = split.get(step, 0.0) + (
            _self_device_us(e) / e.count * per_call / 1e3)
        launches[step] = launches.get(step, 0) + e.count / per_call
    split["total"] = sum(split.values())
    split["seen"] = min(launches.values()) / reps if launches else 0.0
    if other:
        split["other"] = other
    return split


# the diagnostic build's slots (csrc/nibble_update.cu KHMER_CLOCK): phase
# -> slot, and each pass's slot counting its blocks
CLOCK_SLOTS = {"count": 13, "scatter.scan": 8, "scatter.stage": 9,
               "scatter.reserve": 10, "scatter.write": 11,
               "bucket.load": 0, "bucket.sort": 1, "bucket.merge": 2,
               "bucket.commit": 3, "bucket.overflow": 4, "bucket.end": 5}
CLOCK_BLOCKS = {"count": 14, "scatter": 12, "bucket": 6}


def _nvcc_side(name, csrc, defines=()):
    """nvcc csrc/nibble_update.cu into _build/nibble_sides/NAME.so:
    (the library, ptxas's report)."""
    out_dir = os.path.join(cuda.BUILD_DIR, "nibble_sides")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, name + ".so")
    proc = subprocess.run(
        [cuda._nvcc()] + cuda.ARCH_FLAGS
        + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-Xptxas",
           "-v", "-I", csrc, "-o", lib] + ["-D" + d for d in defines]
        + [os.path.join(csrc, "nibble_update.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed on side %s:\n%s" % (name,
                                                            proc.stderr))
    return ctypes.CDLL(lib), _ptxas(proc.stderr)


def build_clocks():
    """This tree's P built with KHMER_NIBBLE_CLOCKS: (update entry, clocks
    entry)."""
    lib, _ = _nvcc_side("clocks", cuda.CSRC, ("KHMER_NIBBLE_CLOCKS",))
    fn = lib.khmer_nibble_update
    fn.argtypes = cuda._ENTRY_POINTS["khmer_nibble_update"]
    fn.restype = ctypes.c_int
    clocks = lib.khmer_nibble_clocks
    clocks.argtypes = [_P]
    clocks.restype = ctypes.c_int
    return fn, clocks


def phase_clocks(fn, clocks, primes, reset, flat, hashes, n, reps=5):
    """Mean cycles a block of each phase of the diagnostic build over
    `reps` calls, each after reset(); and the blocks of each pass a
    call."""
    dev = flat.device
    scratch = K.nibble_update_scratch(None, n, len(primes), dev)
    nbuckets, parts, _ = K.nibble_update_plan(n, len(primes))
    base = scratch.data_ptr()
    primes_arr, offsets_arr = K._layout(primes, nibbles=True)
    n_unique = torch.zeros(1, dtype=torch.int64, device=dev)
    out = (ctypes.c_ulonglong * 16)()
    torch.cuda.synchronize()
    cuda.check(clocks(ctypes.addressof(out)), "clocks")
    for _ in range(reps):
        reset()
        cuda.check(fn(flat.data_ptr(), flat.shape[0], len(primes),
                      ctypes.addressof(primes_arr),
                      ctypes.addressof(offsets_arr), hashes.data_ptr(), n,
                      nbuckets, K.nibble_tiles(n, len(primes))[0],
                      *[base + parts[p][0] for p in K._NIBBLE_PARTS],
                      n_unique.data_ptr(),
                      dev.index, K._stream(dev)), "clocks side")
    torch.cuda.synchronize()
    cuda.check(clocks(ctypes.addressof(out)), "clocks")
    blocks = {k: out[v] / reps for k, v in CLOCK_BLOCKS.items()}
    rec = {}
    for phase, slot in CLOCK_SLOTS.items():
        owner = blocks[phase.split(".")[0]]
        rec[phase] = round(out[slot] / reps / owner, 1) if owner else 0.0
    return {"cycles_a_block": rec, "blocks": blocks}


def build_parent(parent):
    """The parent's khmer_nibble_update, built by nvcc from DIR's csrc into
    _build/nibble_sides/parent.so; and ptxas's registers and spills."""
    lib, report = _nvcc_side("parent", os.path.join(
        os.path.abspath(parent), "khmer_tpu_torch", "csrc"))
    fn = lib.khmer_nibble_update
    fn.argtypes = PARENT_ARGTYPES
    fn.restype = ctypes.c_int
    return fn, report


def _ptxas(report):
    return [line.split("ptxas info    :")[-1].strip()
            for line in report.splitlines()
            if "registers" in line or "spill" in line]


def parent_caller(fn, primes, n, dev):
    """update(flat, n_unique, hashes, with_flags) on the parent's kernel,
    its scratch (update_plan) made once; and its scratch bytes and
    buckets."""
    scratch = K.update_scratch(None, n, len(primes), dev)
    nbuckets, ptr = K._scratch_ptrs(scratch, n, len(primes))
    primes_arr, offsets_arr = K._layout(primes, nibbles=True)

    def update(flat, n_unique, hashes, with_flags=False):
        flags = (torch.empty(n, dtype=torch.bool, device=dev)
                 if with_flags else None)
        cuda.check(fn(flat.data_ptr(), flat.shape[0], len(primes),
                      ctypes.addressof(primes_arr),
                      ctypes.addressof(offsets_arr), hashes.data_ptr(), n,
                      nbuckets, *ptr[:4], K._ptr(flags), n_unique.data_ptr(),
                      dev.index, K._stream(dev)), "parent nibble_update")
        return flags
    return update, K.update_plan(n, len(primes))[2], nbuckets


def design_caller(primes, n, size, dev):
    """update(...) on this tree's kernel P as nibble_update_cuda calls it,
    its scratch (nibble_update_plan) made once; scratch bytes, and the
    buckets in use of the `size`-byte tables."""
    scratch = K.nibble_update_scratch(None, n, len(primes), dev)
    nbuckets = K.nibble_update_plan(n, len(primes))[0]

    def update(flat, n_unique, hashes, with_flags=False):
        return K.nibble_update_cuda(primes, flat, n_unique, hashes, n,
                                    scratch, with_event_new=with_flags)
    return (update, K.nibble_update_plan(n, len(primes))[2],
            K.nibble_buckets(size, nbuckets)[1])


def shape_counts(primes, flat, hashes, n, reset):
    """Events, tables, table bytes, distinct table bytes and sectors, the
    bytes bound and the sector floor of a call; and rmw_ms, the device time
    of a read and a write of each distinct 32-bit word the call touches by
    two library calls (torch.take, then index_put_ of the same values),
    each after reset(): the traffic every design of P must move."""
    from khmer_tpu_torch.ops.u64 import umod

    byte = torch.cat([(umod(hashes[:n], p) + 2 * off) >> 1 for p, off in zip(
        primes, K.nibble_offsets(primes))]).unique()
    sectors = int((byte >> 5).unique().numel())
    words = flat.view(torch.int32)
    widx = (byte >> 2).unique()
    rmw = lambda: words.index_put_((widx,), torch.take(words, widx))
    return {"events": n, "tables": len(primes),
            "table_bytes": int(flat.shape[0]),
            "distinct_bytes": int(byte.numel()), "sectors": sectors,
            "distinct_words": int(widx.numel()),
            "bound_ms": (8 * n + 2 * byte.numel()) / PEAK_BYTES_S * 1e3,
            "floor_ms": 2 * SECTOR * sectors / PEAK_BYTES_S * 1e3,
            "rmw_ms": reset_ms(reset, rmw, REPS, True)[0]}


def _run(main, args, cwd):
    import contextlib
    import io

    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            main(args)
    finally:
        os.chdir(old)


def capture(steps, cwd, which):
    """Run the CLIs `steps` ((main, args), ...) in this process in `cwd`
    and keep one of their P calls (sketch_kernels.nibble_update): (primes,
    the tables' copy before it or None, its hashes, nvalid) of the
    "first", the "largest" (no copy: the shapes zero the tables) or the
    "median" by events (every call's tables copied on the way)."""
    fn = K.nibble_update
    calls = []

    def keep(primes, flat, n_unique, hashes, nvalid, scratch=None,
             with_event_new=False):
        call = (tuple(primes), flat.clone() if which == "median" else None,
                hashes.clone(), int(nvalid))
        if which == "median" or not calls:
            calls.append(call)
        elif which == "largest" and call[3] > calls[0][3]:
            calls[0] = call
        return fn(primes, flat, n_unique, hashes, nvalid, scratch,
                  with_event_new)

    K.nibble_update = keep
    try:
        for main, args in steps:
            _run(main, args, cwd)
    finally:
        K.nibble_update = fn
    if which != "median":
        return calls[0]
    return sorted(calls, key=lambda c: c[3])[(len(calls) - 1) // 2]


def shape_call(shape, tmp, dev):
    """(primes, the tables before the call or None for zeroed ones,
    hashes, nvalid) of a shape."""
    from khmer_tpu_torch.cli import load_into_counting, normalize_by_median

    cwd = tempfile.mkdtemp(dir=tmp)
    if shape == "a":
        from khmer_tpu_torch.scripts.synth_reads import write_reads

        reads = os.path.join(cwd, "synth.fa")
        write_reads(reads)
        head = os.path.join(cwd, "head.fa")
        with open(reads, "rb") as src, open(head, "wb") as dst:
            for _ in range(2 * HEAD_READS):
                dst.write(src.readline())
        os.remove(reads)
        return capture(
            [(normalize_by_median.main, ["-C", "20", "-x", "2e9", "-N", "4",
                                         "--small-count", head])],
            cwd, "largest")
    if shape == "b":
        return capture(
            [(load_into_counting.main, ["-k", "20", "-x", "5e7", "-N", "4",
                                        "--small-count", "sc.ct", DATA])],
            cwd, "first")
    if shape == "c":
        from khmer_tpu_torch.scripts import nibble_cases

        primes = nibble_cases.case_primes("one-hash-x2^20")
        h, n = nibble_cases._chunk_hashes("one-hash-x2^20", primes, 0,
                                          nibble_cases.CHUNK,
                                          np.random.default_rng(0))
        return primes, None, torch.from_numpy(h.view(np.int64).copy()).to(
            dev), n
    return capture([(normalize_by_median.main,
                     ["-C", "20", "-s", "norm.ct", "--small-count", STAMPS])],
                   cwd, "median")


def check(update, primes, reset, flat, hashes, n, want):
    """Hold one call of a side to nibble_update_plain: tables, n_unique and
    new flags."""
    reset()
    n_unique = torch.zeros(1, dtype=torch.int64, device=flat.device)
    flags = update(flat, n_unique, hashes, True)
    torch.cuda.synchronize()
    w_flat, w_nu, w_flags = want
    ok = (torch.equal(flat, w_flat) and int(n_unique) == w_nu
          and torch.equal(flags, w_flags))
    if not ok:
        raise AssertionError("a side differs from nibble_update_plain")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", choices=SHAPES,
                    default=list(SHAPES))
    ap.add_argument("--sides", nargs="+", choices=SIDES,
                    default=list(SIDES))
    ap.add_argument("--parent", metavar="DIR",
                    help="time the kernel of the checkout at DIR in turns")
    ap.add_argument("--clocks", action="store_true",
                    help="also each phase's cycles (a diagnostic build)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("nibble_update_bench needs a CUDA device")
    if "parent" in a.sides and not a.parent:
        raise SystemExit("side parent needs --parent DIR")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = "%s [%s]" % (torch.cuda.get_device_name(dev), subprocess.run(
        ["nvidia-smi", "-i", str(dev.index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    cuda.library()
    ptxas = {}
    parent_fn = None
    if "parent" in a.sides:
        parent_fn, ptxas["parent"] = build_parent(a.parent)
    clock_fns = build_clocks() if a.clocks else None
    print(json.dumps({"card": card, "ptxas": ptxas}), flush=True)
    turns = list(a.sides) + list(a.sides)[::-1]
    with tempfile.TemporaryDirectory(prefix=".nibble_update_bench_",
                                     dir=_REPO) as tmp:
        for shape in a.shapes:
            t0 = time.perf_counter()
            primes, before, hashes, n = shape_call(shape, tmp, dev)
            setup_s = time.perf_counter() - t0
            size = K.nibble_flat_size(primes)
            flat = torch.empty(size, dtype=torch.uint8, device=dev)
            if before is None:
                before = torch.zeros_like(flat)

            def reset():
                flat.copy_(before)

            reset()
            want_nu = torch.zeros(1, dtype=torch.int64, device=dev)
            want_flags = K.nibble_update_plain(primes, flat, want_nu, hashes,
                                               n, with_event_new=True)
            want = (flat.clone(), int(want_nu), want_flags)
            counts = dict(shape_counts(primes, flat, hashes, n, reset),
                          setup_s=setup_s)
            callers = {}
            if parent_fn is not None:
                callers["parent"] = parent_caller(parent_fn, primes, n, dev)
            if "design" in a.sides:
                callers["design"] = design_caller(primes, n, size, dev)
            n_unique = torch.zeros(1, dtype=torch.int64, device=dev)
            for side in turns:
                update, scratch, buckets = callers[side]
                check(update, primes, reset, flat, hashes, n, want)
                call = lambda: update(flat, n_unique, hashes)
                rec = {"ms": reset_ms(reset, call, REPS, False)[0],
                       "device_ms": reset_ms(reset, call, REPS, True)[0],
                       "split": pass_split(side, reset, call)}
                print(json.dumps(dict(
                    shape=shape, side=side, card=card, **counts,
                    scratch_bytes=scratch, buckets=buckets, **rec)),
                    flush=True)
            if clock_fns is not None:
                print(json.dumps(dict(
                    shape=shape, side="design clocks", card=card,
                    **phase_clocks(*clock_fns, primes, reset, flat, hashes,
                                   n))), flush=True)
            del flat, before, hashes, want, callers
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
