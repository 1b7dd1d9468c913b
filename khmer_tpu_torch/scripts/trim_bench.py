#!/usr/bin/env python
"""Kernels G and H (csrc/trim_prepass.cu and csrc/trim_scan.cu,
csrc/read_counts.cu) on windows of config 3 as the CLI gives them.

Config 3 here is trim-low-abund -k 20 -x 5e7 -N 4 -C 2 on
data/stamps-reads.fa.gz (the reference's parameters). This script runs the
port's ScanTrimmerState over the file's first windows, as the CLI forms
them (cli/trim_low_abund.py, WINDOW bundles each), then, on the next window
and the tables as the earlier windows left them, times kernel G whole (its
pre-pass's mark and probe launches and its walk) against
trim_window_plain, each of G's three launches against its plain version
(trim_mark_plain, trim_probe_plain, trim_walk_plain), and kernel H (on the
window's reads, one a row, as pass 2 and filter-abund read them) against
read_counts_plain, each checked equal, beside their bounds (the larger of
bytes over 3.35 TB/s and operations over 67 TOP/s, H100 SXM):
  * G reads the codes and lengths, each distinct counter of the window's
    k-mers once (1 B each), writes each distinct counter of the consumed
    bundles' k-mers once and its outputs (4 B of branch and 8 B of trim
    positions a bundle); one operation per counter read or added;
  * the mark: the codes and lengths, each distinct counter once, the set
    (cleared and filled: its bytes once) and 13 B of outputs a bundle;
    one operation per counter read and per candidate's counter marked;
  * the probe: the state (1 B a bundle), the probed bundles' codes and
    lengths and each distinct counter of theirs (the set's words they
    read not counted); one operation per counter read;
  * the walk: the state, the live bundles' codes and lengths, each
    distinct counter they read, each one they add to, 12 B of outputs a
    live bundle; one operation per counter read or added;
  * H reads the codes and lengths and each distinct counter once, writes 8
    B a read; one operation per counter read. Its counter reads are
    random, and DRAM serves whole 32-byte sectors, so it also has a sector
    floor: the same bytes with 32 B for each distinct sector its counters
    lie in. Beside its times, the share of its counter loads that a
    staging by table 0 would save (tables 1..T-1 of the windows whose
    table-0 count alone settles them: below min(cutoff, at_least, 255)),
    on the window's reads and on its consumed reads against the tables
    after the consume (the reads and tables of pass 2).
Each of G's timed calls starts from the state it needs, restored before
the call's events (the tables and n_unique; the probe's state). Times are
as issued (CUDA events around each call) and on the device alone (the
stream held by a sleep kernel while the call is issued,
scripts.device_ms). Kernel H alone is also timed on H_SHAPES: (a) window
6 of config 3, (b) window 6 of trim-low-abund -x 1e9 -N 4 on
scripts/synth_reads.py's reads (4 GB of tables), (c) one long-read run as
core/diginorm_scan.py row_runs packs reads of 5,000-15,000 bases, (d) one
row of 1,000,000 codes, the shape Countgraph.median_at_least sends for a
1 Mb sequence; (c) and (d) on config 3's 200 MB of tables, seeded. Needs a
CUDA card, but for --counts, which runs on any device. From the repo
root:

    python -m khmer_tpu_torch.scripts.trim_bench [--at 0 6]
    python -m khmer_tpu_torch.scripts.trim_bench --shapes a b c d
    python -m khmer_tpu_torch.scripts.trim_bench --parent DIR [--at 0 6]
    python -m khmer_tpu_torch.scripts.trim_bench --counts 13 --device cpu

The first times G and H on window 6, or the windows given (one JSON line
each; chip_smoke.py phase 8b calls time_window on its own reads and
tables). The second times H alone on the shapes given (one JSON line
each; (b) writes the synthetic reads first, into a directory of its own
in the repo root, removed after). The third times H on the shapes of
--shapes (default a b c d) and, with --at, G and H on those windows, in
turns with another checkout of the repo at DIR, parent, this one, this
one, parent: each side a process of its own, running this file's timing
code on its own checkout's kernels (H's wrapper takes the same arguments
in both), one JSON line a shape or window tagged with its side. The
fourth prints, for each of the file's first 13 windows, its bundles,
candidates, live bundles, the walk's groups and the consumed bundles.
"""

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from khmer_tpu_torch.cli.trim_low_abund import _windows
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.diginorm_scan import (LONG_RUN_BYTES,
                                                ScanTrimmerState,
                                                pack_reads, pack_window,
                                                row_runs)
from khmer_tpu_torch.core.sketch import Countgraph
from khmer_tpu_torch.io.fastx import ReadParser
from khmer_tpu_torch.io.pairing import broken_paired_reader
from khmer_tpu_torch.ops.u64 import umod
from khmer_tpu_torch.scripts import cuda_ms, device_ms, reset_ms
from khmer_tpu_torch.scripts.byte_gather_bench import PEAK_BYTES_S
from khmer_tpu_torch.scripts.diginorm_bench import SECTOR, STAMPS, bound_ms

# kernel H's shapes: (what, table size -x, row length, rows, read lengths)
H_SHAPES = {
    "a": ("window 6 of config 3", 5e7, None, None, None),
    "b": ("window 6 at -x 1e9 -N 4", 1e9, None, None, None),
    "c": ("one long-read run", 5e7, 15000, LONG_RUN_BYTES // (2 * 15000),
          (5000, 15000)),
    "d": ("one row of 1,000,000 codes", 5e7, 1_000_000, 1,
          (1_000_000, 1_000_000)),
}


def _counters(primes, hashes, valid):
    """(distinct counters, counter reads, distinct sectors) of the valid
    windows' k-mers."""
    h = hashes[valid]
    idx = torch.unique(torch.cat([umod(h, p) + o for p, o in zip(
        primes, K.byte_offsets(primes))]))
    return (int(idx.numel()), int(valid.sum()) * len(primes),
            int(torch.unique(idx // SECTOR).numel()))


def _rows(flags):
    """A bundle flag [B] as a row flag [2B, 1]."""
    return flags.repeat_interleave(2)[:, None]


def bounds(primes, k, codes, lengths, branch, cand, probed, live, words):
    """{name: (bytes, operations)} of one window (module docstring): "G"
    whole, its launches "mark", "probe" and "walk", from the bundle rows,
    the branches, the candidates, the bundles probed and the live ones, and
    the set's words."""
    hashes, valid, _ = K._window_hashes(codes, lengths, k)
    read, ops_read, _ = _counters(primes, hashes, valid)
    written, ops_add, _ = _counters(primes, hashes,
                                    valid & _rows(branch == 2))
    B = branch.shape[0]
    rows_bytes = codes.numel() + 4 * lengths.numel()
    row = codes.shape[1] + 4
    _, ops_mark, _ = _counters(primes, hashes, valid & _rows(cand))
    p_read, p_ops, _ = _counters(primes, hashes, valid & _rows(probed))
    n_probed = int(probed.sum())
    w_read, w_ops, _ = _counters(primes, hashes, valid & _rows(live))
    n_live = int(live.sum())
    out = {
        "G": (rows_bytes + read + written + 12 * B, ops_read + ops_add),
        "mark": (rows_bytes + read + 4 * words + 13 * B, ops_read + ops_mark),
        "probe": (B + 2 * n_probed * row + p_read, p_ops),
        "walk": (B + 2 * n_live * row + w_read + written + 12 * n_live,
                 w_ops + ops_add),
    }
    return out


def counts_bounds(primes, k, rows, row_lengths):
    """(bytes, operations, sector-floor bytes) of kernel H on read rows
    (module docstring)."""
    hashes, valid, _ = K._window_hashes(rows, row_lengths, k)
    read, ops, sectors = _counters(primes, hashes, valid)
    rest = rows.numel() + 4 * row_lengths.numel() + 8 * rows.shape[0]
    return rest + read, ops, rest + SECTOR * sectors


def staging_share(primes, k, cutoff, at_least, flat, rows, row_lengths):
    """The share of kernel H's counter loads (valid windows x tables) that
    a staging by table 0 would save: tables 1..T-1 of the windows whose
    table-0 count is below min(cutoff, at_least, 255) (they are below
    cutoff and at_least whatever the other tables hold)."""
    hashes, valid, _ = K._window_hashes(rows, row_lengths, k)
    low = min(int(cutoff), int(at_least), K.MAX_KCOUNT)
    settled = valid & (flat[umod(hashes, primes[0])].to(torch.int32) < low)
    T = len(primes)
    return int(settled.sum()) * (T - 1) / max(int(valid.sum()) * T, 1)


def time_counts(primes, k, cutoff, at_least, flat, rows, row_lengths,
                reps):
    """Kernel H on read rows against read_counts_plain: ms as issued and
    on the device, the plain version's, mismatches, bounds and sector
    floor, the staging share and the rows' shape."""
    args = (primes, k, cutoff, at_least, flat, rows, row_lengths)
    ms = cuda_ms(lambda: K.read_counts_cuda(*args), reps)
    dev_ms = device_ms(lambda: K.read_counts_cuda(*args), reps)
    plain = cuda_ms(lambda: K.read_counts_plain(*args), 1)
    err = _mismatch(K.read_counts_cuda(*args), K.read_counts_plain(*args))
    nbytes, ops, sector_bytes = counts_bounds(primes, k, rows, row_lengths)
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain,
            "mismatches": err, "bytes": nbytes, "ops": ops,
            "bound": bound_ms(nbytes, ops), "sector_bytes": sector_bytes,
            "sector_ms": sector_bytes / PEAK_BYTES_S * 1e3,
            "staging": staging_share(primes, k, cutoff, at_least, flat,
                                     rows, row_lengths),
            "rows": rows.shape[0], "L": rows.shape[1]}


def first_windows(path, k, at):
    """Windows 0..at of `path` as the CLI forms them."""
    reader = broken_paired_reader(ReadParser(path), min_length=k)
    return list(itertools.islice(_windows(reader), at + 1))


def window_state(dev, path, k, cutoff, trim_cov, x, n_tables, at):
    """(countgraph, bundles, row length) of window `at` of `path`, the
    countgraph as the port's ScanTrimmerState left it after windows
    0..at-1. The window must pack as one run (reads of at most 4096
    bases)."""
    cg = Countgraph(k, x, n_tables, device=dev)
    scan = ScanTrimmerState(cg, cutoff, trim_cov)
    windows = first_windows(path, k, at)
    for w in windows[:at]:
        scan.process_window(w)
    (_, _, L), = row_runs(windows[at], k)
    return cg, windows[at], L


def shape_rows(dev, L, R, lens, seed=2027):
    """Seeded read rows of kernel H's shapes (c) and (d): R reads of
    uniform lengths in `lens` drawn from a random genome, at rows of L."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, max(L, 200_000) + 1, dtype=np.uint8)
    lengths = rng.integers(lens[0], lens[1] + 1, R).astype(np.int32)
    codes = np.zeros((R, L), dtype=np.uint8)
    for r, n in enumerate(lengths):
        s0 = int(rng.integers(0, genome.shape[0] - n + 1))
        codes[r, :n] = genome[s0:s0 + n]
    return (torch.from_numpy(codes).to(dev),
            torch.from_numpy(lengths).to(dev))


def shape_inputs(dev, shape, reads=None, k=20, cutoff=2, trim_cov=20,
                 n_tables=4):
    """(primes, tables, rows, lengths) of one of H_SHAPES (module
    docstring): (a) and (b) window 6's reads against the tables windows
    0..5 left, (b) from `reads`, the synthetic reads' path; (c) and (d)
    seeded rows against config 3's tables filled with counts of 3 to 40
    (seeded)."""
    _, x, L, R, lens = H_SHAPES[shape]
    if L is None:
        cg, bundles, L = window_state(dev, STAMPS if shape == "a" else reads,
                                      k, cutoff, trim_cov, x, n_tables, 6)
        rows, lengths = (torch.from_numpy(a).to(dev) for a in pack_reads(
            [r.cleaned_seq for b in bundles for r in b], L))
        return cg._primes, cg.tables.flat, rows, lengths
    primes = tuple(K.get_n_primes_near_x(n_tables, x))
    gen = torch.Generator(device=dev).manual_seed(2027)
    flat = torch.randint(3, 41, (K.byte_flat_size(primes),),
                         dtype=torch.uint8, device=dev, generator=gen)
    return (primes, flat) + shape_rows(dev, L, R, lens)


def time_shape(dev, shape, reads=None, k=20, cutoff=2, trim_cov=20,
               n_tables=4, reps=20):
    """Kernel H alone on one of H_SHAPES (shape_inputs), at config 3's
    cutoff and trim coverage: time_counts' result with the shape's name."""
    primes, flat, rows, lengths = shape_inputs(dev, shape, reads, k, cutoff,
                                               trim_cov, n_tables)
    if shape == "d":
        reps = max(reps // 4, 1)
    out = time_counts(primes, k, cutoff, trim_cov, flat, rows, lengths, reps)
    del flat
    torch.cuda.empty_cache()
    return dict(shape=shape, what=H_SHAPES[shape][0],
                device=torch.cuda.get_device_name(dev), **out)


def _both(reset, fn, reps):
    """(ms as issued, ms on the device, the last result) of reset_ms."""
    issued, _ = reset_ms(reset, fn, reps, False)
    device, out = reset_ms(reset, fn, reps, True)
    return issued, device, out


def _mismatch(got, want):
    return sum(int((a != b).sum()) for a, b in zip(got, want))


def time_window(dev, path=STAMPS, k=20, cutoff=2, trim_cov=20, x=5e7,
                n_tables=4, at=6, reps=5):
    """Window `at` of `path` (after windows 0..at-1 went through the port's
    ScanTrimmerState): kernel G whole and its three launches, and kernel H,
    against their plain versions: times, bounds, mismatches and the
    window's candidates, live bundles and groups. The window must pack as
    one run (reads of at most 4096 bases)."""
    cg, bundles, L = window_state(dev, path, k, cutoff, trim_cov, x,
                                  n_tables, at)
    codes, lengths = (torch.from_numpy(a).to(dev)
                      for a in pack_window(bundles, L))
    reads = [r.cleaned_seq for b in bundles for r in b]
    rows, row_lengths = (torch.from_numpy(a).to(dev)
                         for a in pack_reads(reads, L))
    primes, flat, nu = cg._primes, cg.tables.flat, cg._n_unique
    snap, nu0 = flat.clone(), nu.clone()
    B = len(bundles)
    plan = K.trim_plan(len(primes), B, L - k + 1)
    args = (primes, k, cutoff)

    def restore():
        flat.copy_(snap)
        nu.copy_(nu0)

    # H first: it reads the tables as the earlier windows left them
    counts = time_counts(primes, k, cutoff, trim_cov, flat, rows,
                         row_lengths, reps * 4)

    # the pre-pass's launches, each against its plain version
    marks = torch.empty(plan["mark_words"], dtype=torch.int32, device=dev)
    mark_ms, mark_dev, marked = _both(lambda: None, lambda: K.trim_mark_cuda(
        *args, trim_cov, None, flat, codes, lengths, marks), reps)
    marks_p = torch.zeros_like(marks)
    mark_plain, marked_p = reset_ms(lambda: marks_p.zero_(),
                                    lambda: K.trim_mark_plain(
                                        *args, trim_cov, None, flat, codes,
                                        lengths, marks_p), 1, False)
    mark_err = (_mismatch(marked, marked_p)
                + int((marks != marks_p).sum()))
    state0 = marked[0].clone()
    state = state0.clone()
    probe_ms, probe_dev, _ = _both(
        lambda: state.copy_(state0), lambda: K.trim_probe_cuda(
            *args, None, flat, codes, lengths, marks, state), reps)
    state_p = state0.clone()
    probe_plain, _ = reset_ms(lambda: state_p.copy_(state0),
                              lambda: K.trim_probe_plain(
                                  *args, None, flat, codes, lengths, marks,
                                  state_p), 1, False)
    probe_err = int((state != state_p).sum())

    # the walk from the pre-pass's outputs, then G whole
    branch, trim_at = (t.clone() for t in marked[1:])
    n_live = torch.zeros(1, dtype=torch.int64, device=dev)
    n_groups = torch.zeros(1, dtype=torch.int64, device=dev)
    walk_ms, walk_dev, _ = _both(restore, lambda: K.trim_walk_cuda(
        *args, trim_cov, None, flat, nu, codes, lengths, state, branch,
        trim_at), reps)
    restore()
    K.trim_walk_cuda(*args, trim_cov, None, flat, nu, codes, lengths, state,
                     branch, trim_at, n_live, n_groups)
    walk_tables, walk_nu = flat.clone(), int(nu)
    branch_w, trim_w = (t.clone() for t in marked_p[1:])
    walk_plain, _ = reset_ms(restore, lambda: K.trim_walk_plain(
        *args, trim_cov, None, flat, nu, codes, lengths, state_p, branch_w,
        trim_w), 1, False)
    walk_err = (_mismatch((branch, trim_at), (branch_w, trim_w))
                + abs(walk_nu - int(nu))
                + (0 if torch.equal(walk_tables, flat) else 1))

    g_ms, g_dev, (g_branch, g_trim) = _both(restore, lambda: K.trim_scan_cuda(
        *args, trim_cov, None, flat, nu, codes, lengths), reps)
    g_tables, g_nu = flat.clone(), int(nu)
    # the reads pass 2 reads, against the tables after their consume
    consumed = [r.cleaned_seq for b, x in zip(bundles, g_branch.tolist())
                if x == 2 for r in b]
    if consumed:
        c2, n2 = (torch.from_numpy(a).to(dev)
                  for a in pack_reads(consumed, L))
        counts["staging_pass2"] = staging_share(primes, k, cutoff, trim_cov,
                                                flat, c2, n2)
    g_plain, (branch_p, trim_p) = reset_ms(
        restore, lambda: K.trim_window_plain(
            *args, trim_cov, None, flat, nu, codes, lengths), 1, False)
    scan_err = (_mismatch((g_branch, g_trim), (branch_p, trim_p))
                + abs(g_nu - int(nu))
                + (0 if torch.equal(g_tables, flat) else 1))
    flat.copy_(snap)
    cand = state0 == K.TRIM_LIVE
    probed = state0 >= K.TRIM_PROBE
    live = state == K.TRIM_LIVE
    b = bounds(primes, k, codes, lengths, branch_p, cand, probed, live,
               plan["mark_words"])

    def entry(ms, device, plain, err, key):
        return {"ms": ms, "device_ms": device, "plain_ms": plain,
                "mismatches": err, "bytes": b[key][0], "ops": b[key][1],
                "bound": bound_ms(*b[key][:2])}

    g = entry(g_ms, g_dev, g_plain, scan_err, "G")
    g["us_per_bundle"] = g_ms * 1e3 / max(B, 1)
    walk = entry(walk_ms, walk_dev, walk_plain, walk_err, "walk")
    walk["us_per_live"] = walk_dev * 1e3 / max(int(live.sum()), 1)
    return {
        "device": torch.cuda.get_device_name(dev), "window": at,
        "bundles": B, "reads": len(reads), "L": L,
        "branches": torch.bincount(branch_p.long(), minlength=3).tolist(),
        "candidates": int(cand.sum()), "probed": int(probed.sum()),
        "live": int(live.sum()), "groups": int(n_groups),
        "mark_bits": plan["mark_bits"],
        "scan": g,
        "mark": entry(mark_ms, mark_dev, mark_plain, mark_err, "mark"),
        "probe": entry(probe_ms, probe_dev, probe_plain, probe_err, "probe"),
        "walk": walk,
        "counts": counts,
    }


def window_counts(dev, path=STAMPS, k=20, cutoff=2, trim_cov=20, x=5e7,
                  n_tables=4, windows=13):
    """The first `windows` windows of `path` through the port's
    ScanTrimmerState on `dev`: per window {bundles, candidates, live,
    groups, consumed}."""
    scan = ScanTrimmerState(Countgraph(k, x, n_tables, device=dev), cutoff,
                            trim_cov)
    out = []
    for i, w in enumerate(first_windows(path, k, windows - 1)):
        before = [int(c) for c in (scan.candidates, scan.live, scan.groups)]
        branch, _ = scan.process_window(w)
        after = [int(c) for c in (scan.candidates, scan.live, scan.groups)]
        out.append(dict(window=i, bundles=len(w), consumed=int(
            (branch == 2).sum()), **{name: a - b for name, a, b in zip(
                ("candidates", "live", "groups"), after, before)}))
    return out


# One side of in_turns, run in the root of its checkout (its package
# first on the path): this file's time_shape of each shape and
# time_window of each window, on that checkout's kernels.
_SIDE = ("import importlib.util as iu, json, sys, torch\n"
         "spec = iu.spec_from_file_location('bench', sys.argv[1])\n"
         "bench = iu.module_from_spec(spec)\n"
         "spec.loader.exec_module(bench)\n"
         "dev = torch.device('cuda', 0)\n"
         "reads, shapes, ats = json.loads(sys.argv[2])\n"
         "for shape in shapes:\n"
         "    print(json.dumps(bench.time_shape(dev, shape, reads)),\n"
         "          flush=True)\n"
         "for at in ats:\n"
         "    print(json.dumps(bench.time_window(dev, at=at)), flush=True)\n")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def in_turns(parent, shapes, ats, reads=None):
    """Kernel H on `shapes` and windows `ats` timed on the kernels of the
    checkout at `parent` and of this one in turns, parent, this, this,
    parent, each side in a process of its own: yields (side, result)."""
    job = json.dumps([reads, shapes, ats])
    for side, root in (("parent", parent), ("change", _REPO),
                       ("change", _REPO), ("parent", parent)):
        out = subprocess.run(
            [sys.executable, "-c", _SIDE, os.path.abspath(__file__), job],
            cwd=root, capture_output=True, text=True, check=True).stdout
        for line in out.splitlines():
            yield side, json.loads(line)


def _synth_dir(shapes):
    """A directory in the repo root holding the synthetic reads when shape
    (b) is asked for, else None."""
    if "b" not in shapes:
        return None
    from khmer_tpu_torch.scripts.synth_reads import write_reads

    tmp = tempfile.TemporaryDirectory(prefix=".trim_bench_", dir=_REPO)
    write_reads(os.path.join(tmp.name, "synth.fa"))
    return tmp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--at", type=int, nargs="+",
                    help="windows to time G and H on (default: 6, none "
                    "with --parent)")
    ap.add_argument("--shapes", nargs="+", choices=sorted(H_SHAPES),
                    help="H_SHAPES to time H alone on (default with "
                    "--parent: a b c d)")
    ap.add_argument("--parent", metavar="DIR",
                    help="time them in turns with the checkout at DIR")
    ap.add_argument("--counts", type=int, default=0,
                    help="print the first N windows' counts instead")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.counts:
        for row in window_counts(torch.device(a.device), windows=a.counts):
            print(json.dumps(row), flush=True)
        return
    if not torch.cuda.is_available():
        raise RuntimeError("trim_bench needs a CUDA device")
    shapes = a.shapes or (sorted(H_SHAPES) if a.parent else [])
    ats = a.at or ([] if a.parent or a.shapes else [6])
    tmp = _synth_dir(shapes)
    reads = tmp and os.path.join(tmp.name, "synth.fa")
    try:
        if a.parent:
            for side, out in in_turns(a.parent, shapes, ats, reads):
                print(json.dumps(dict(side=side, **out)), flush=True)
            return
        dev = torch.device("cuda", torch.cuda.current_device())
        for shape in shapes:
            print(json.dumps(time_shape(dev, shape, reads)), flush=True)
        for at in ats:
            print(json.dumps(time_window(dev, at=at)), flush=True)
    finally:
        if tmp is not None:
            tmp.cleanup()


if __name__ == "__main__":
    main()
