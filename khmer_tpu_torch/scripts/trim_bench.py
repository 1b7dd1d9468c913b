#!/usr/bin/env python
"""Kernels G and H (csrc/trim_scan.cu, csrc/read_counts.cu) on one window
of config 3 as the CLI gives it, on the card.

Config 3 here is trim-low-abund -k 20 -x 5e7 -N 4 -C 2 on
data/stamps-reads.fa.gz (the reference's parameters). This script runs the
port's ScanTrimmerState over the file's first windows, as the CLI forms
them (cli/trim_low_abund.py, WINDOW bundles each), then, on the next window
and the tables as the earlier windows left them, times kernel G against
trim_window_plain and kernel H (on the window's reads, one a row, as pass 2
and filter-abund read them) against read_counts_plain, each checked equal,
beside their bounds (the larger of bytes over 3.35 TB/s and operations over
67 TOP/s, H100 SXM):
  * G reads the codes and lengths, each distinct counter of the window's
    k-mers once (1 B each), writes each distinct counter of the consumed
    bundles' k-mers once and its outputs (4 B of branch and 8 B of trim
    positions a bundle); one operation per counter read or added;
  * H reads the codes and lengths and each distinct counter once, writes 8
    B a read; one operation per counter read. Its counter reads are
    random, and DRAM serves whole 32-byte sectors, so it also has a sector
    floor: the same bytes with 32 B for each distinct sector its counters
    lie in.
G changes the tables, so each of its timed calls starts from a copy of
them, made before the call's events. Both are timed as issued
(scripts.cuda_ms); G takes far longer than the host needs to issue it.
Needs a CUDA card. From the repo root (window 6; chip_smoke.py phase 8b
calls time_window on its own reads and tables):

    python -m khmer_tpu_torch.scripts.trim_bench
"""

import itertools
import json

import torch

from khmer_tpu_torch.cli.trim_low_abund import _windows
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.diginorm_scan import (ScanTrimmerState,
                                                pack_reads, pack_window,
                                                row_runs)
from khmer_tpu_torch.core.sketch import Countgraph
from khmer_tpu_torch.io.fastx import ReadParser
from khmer_tpu_torch.io.pairing import broken_paired_reader
from khmer_tpu_torch.ops.u64 import umod
from khmer_tpu_torch.scripts import cuda_ms
from khmer_tpu_torch.scripts.byte_gather_bench import PEAK_BYTES_S
from khmer_tpu_torch.scripts.diginorm_bench import (SECTOR, STAMPS,
                                                    _timed_from, bound_ms)


def _counters(primes, hashes, valid):
    """(distinct counters, counter reads, distinct sectors) of the valid
    windows' k-mers."""
    h = hashes[valid]
    idx = torch.unique(torch.cat([umod(h, p) + o for p, o in zip(
        primes, K.byte_offsets(primes))]))
    return (int(idx.numel()), int(valid.sum()) * len(primes),
            int(torch.unique(idx // SECTOR).numel()))


def bounds(primes, k, codes, lengths, branch, rows, row_lengths):
    """{"G": (bytes, operations), "H": (bytes, operations, sector-floor
    bytes)} of one window (module docstring): G's from its bundle rows and
    branches, H's from its read rows."""
    hashes, valid, _ = K._window_hashes(codes, lengths, k)
    read, ops_read, _ = _counters(primes, hashes, valid)
    consumed = valid & (branch == 2).repeat_interleave(2)[:, None]
    written, ops_add, _ = _counters(primes, hashes, consumed)
    B = branch.shape[0]
    g = (codes.numel() + 4 * lengths.numel() + read + written + 12 * B,
         ops_read + ops_add)
    hashes, valid, _ = K._window_hashes(rows, row_lengths, k)
    h_read, h_ops, h_sectors = _counters(primes, hashes, valid)
    rest = rows.numel() + 4 * row_lengths.numel() + 8 * rows.shape[0]
    return {"G": g, "H": (rest + h_read, h_ops, rest + SECTOR * h_sectors)}


def first_windows(path, k, at):
    """Windows 0..at of `path` as the CLI forms them."""
    reader = broken_paired_reader(ReadParser(path), min_length=k)
    return list(itertools.islice(_windows(reader), at + 1))


def time_window(dev, path=STAMPS, k=20, cutoff=2, trim_cov=20, x=5e7,
                n_tables=4, at=6, reps=5):
    """Window `at` of `path` (after windows 0..at-1 went through the port's
    ScanTrimmerState): kernels G and H against their plain versions, times,
    bounds and mismatches. The window must pack as one run (reads of at
    most 4096 bases)."""
    cg = Countgraph(k, x, n_tables, device=dev)
    scan = ScanTrimmerState(cg, cutoff, trim_cov)
    windows = first_windows(path, k, at)
    for w in windows[:at]:
        scan.process_window(w)
    bundles = windows[at]
    (_, _, L), = row_runs(bundles, k)
    codes, lengths = (torch.from_numpy(a).to(dev)
                      for a in pack_window(bundles, L))
    reads = [r.cleaned_seq for b in bundles for r in b]
    rows, row_lengths = (torch.from_numpy(a).to(dev)
                         for a in pack_reads(reads, L))
    primes, flat, nu = cg._primes, cg.tables.flat, cg._n_unique
    snap, nu0 = flat.clone(), nu.clone()

    # H first: it reads the tables as the earlier windows left them
    def counts():
        return K.read_counts_cuda(primes, k, cutoff, trim_cov, flat, rows,
                                  row_lengths)

    h_ms = cuda_ms(counts, reps * 4)
    got = counts()
    h_plain = cuda_ms(lambda: K.read_counts_plain(
        primes, k, cutoff, trim_cov, flat, rows, row_lengths), 1)
    want = K.read_counts_plain(primes, k, cutoff, trim_cov, flat, rows,
                               row_lengths)
    counts_err = sum(int((a != b).sum()) for a, b in zip(got, want))

    g_ms, (branch, trim_at) = _timed_from(
        flat, snap, nu, nu0, lambda: K.trim_scan_cuda(
            primes, k, cutoff, trim_cov, None, flat, nu, codes, lengths),
        reps)
    g_tables, g_nu = flat.clone(), int(nu)
    g_plain, (branch_p, trim_p) = _timed_from(
        flat, snap, nu, nu0, lambda: K.trim_window_plain(
            primes, k, cutoff, trim_cov, None, flat, nu, codes, lengths), 1)
    scan_err = (int((branch != branch_p).sum())
                + int((trim_at != trim_p).sum()) + abs(g_nu - int(nu))
                + (0 if torch.equal(g_tables, flat) else 1))
    b = bounds(primes, k, codes, lengths, branch, rows, row_lengths)
    B = len(bundles)
    return {
        "device": torch.cuda.get_device_name(dev), "window": at,
        "bundles": B, "reads": len(reads), "L": L,
        "branches": torch.bincount(branch.long(), minlength=3).tolist(),
        "scan": {"ms": g_ms, "plain_ms": g_plain, "mismatches": scan_err,
                 "us_per_bundle": g_ms * 1e3 / max(B, 1),
                 "bytes": b["G"][0], "ops": b["G"][1],
                 "bound": bound_ms(*b["G"])},
        "counts": {"ms": h_ms, "plain_ms": h_plain,
                   "mismatches": counts_err, "bytes": b["H"][0],
                   "ops": b["H"][1], "bound": bound_ms(*b["H"][:2]),
                   "sector_bytes": b["H"][2],
                   "sector_ms": b["H"][2] / PEAK_BYTES_S * 1e3},
    }


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("trim_bench needs a CUDA device")
    print(json.dumps(time_window(torch.device(
        "cuda", torch.cuda.current_device()))))


if __name__ == "__main__":
    main()
