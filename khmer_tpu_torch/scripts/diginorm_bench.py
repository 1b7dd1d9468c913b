#!/usr/bin/env python
"""Kernels E and F (csrc/diginorm_med.cu, csrc/diginorm_scan.cu) on one
window of config 2 as the CLI gives it, on the card.

Config 2 is normalize-by-median -C 20 on data/stamps-reads.fa.gz with the
defaults (k 32, 4 tables of about 1e6 bytes). This script runs the port's
ScanNormalizer over the file's first windows, as the CLI forms them
(cli/normalize_by_median.py read_windows, WINDOW bundles each), then, on
the next window and the tables as the earlier windows left them, times
kernel E and kernel F against their plain versions, checked equal, beside
their bounds (the larger of bytes over 3.35 TB/s and operations over 67
TOP/s, H100 SXM):
  * E reads the codes, the lengths and each distinct counter of the
    window's k-mers once (1 B each) and writes a flag a bundle; one
    operation per counter read. Its counter reads are random, and DRAM
    serves whole 32-byte sectors, so it also has a sector floor: the
    same bytes with 32 B for each distinct sector its counters lie in.
    That floor counts every counter of every window (as it did before E
    loaded its tables in rounds); the rule's floor counts the sectors of
    the counters E's rule loads (sketch_kernels.med_load_plan). E is
    timed as issued (scripts.cuda_ms) and as the device sees it
    (scripts.device_ms), and its load counter is held to the rule's;
  * F reads the candidates' codes and lengths, the flags, each distinct
    counter of the candidates' k-mers once, writes each distinct counter
    of the kept bundles' k-mers once and a flag a bundle; one operation
    per counter read or added.
F changes the tables, so each of its timed calls starts from a copy of
them, made before the call's events. Needs a CUDA card. From the repo
root (config 2's window 6; chip_smoke.py phase 7b calls time_window on
its own reads and tables):

    python -m khmer_tpu_torch.scripts.diginorm_bench
"""

import itertools
import json
import os

import torch

from khmer_tpu_torch.cli.normalize_by_median import read_windows
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.diginorm_scan import (ScanNormalizer, pack_window,
                                                row_runs)
from khmer_tpu_torch.core.sketch import Countgraph
from khmer_tpu_torch.ops.u64 import umod
from khmer_tpu_torch.scripts import cuda_ms, device_ms
from khmer_tpu_torch.scripts.byte_gather_bench import PEAK_BYTES_S

STAMPS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "stamps-reads.fa.gz")
PEAK_OPS_S = 67e12  # H100 SXM, 32-bit operations outside tensor cores
SECTOR = 32  # bytes DRAM serves for one random read


def bounds(primes, k, codes, lengths, reject, keep, loaded):
    """{"E": (bytes, operations, sector-floor bytes, the rule's
    sector-floor bytes), "F": (bytes, operations)} of one window (module
    docstring), from its device tensors, flags and the counters E's rule
    loads (`loaded`, med_load_plan's)."""
    hashes, valid, _ = K._window_hashes(codes, lengths, k)
    offsets = K.byte_offsets(primes)
    rule = torch.cat([(umod(hashes, p) + o)[loaded[t]]
                      for t, (p, o) in enumerate(zip(primes, offsets))])
    rule_sectors = int(torch.unique(rule // SECTOR).numel())

    def counters(bundles):
        """(distinct counters, counter reads, distinct sectors)."""
        v = valid & bundles.repeat_interleave(2)[:, None]
        h = hashes[v]
        idx = torch.unique(torch.cat([umod(h, p) + o
                                      for p, o in zip(primes, offsets)]))
        return (int(idx.numel()), int(v.sum()) * len(primes),
                int(torch.unique(idx // SECTOR).numel()))

    B = reject.shape[0]
    e_counters, e_ops, e_sectors = counters(torch.ones_like(reject))
    f_read, f_ops_read, _ = counters(~reject)
    f_write, f_ops_add, _ = counters(keep)
    ncand = int((~reject).sum())
    e_rest = codes.numel() + 4 * lengths.numel() + B
    return {
        "E": (e_rest + e_counters, e_ops, e_rest + SECTOR * e_sectors,
              e_rest + SECTOR * rule_sectors),
        "F": (ncand * (2 * codes.shape[1] + 8) + 2 * B + f_read + f_write,
              f_ops_read + f_ops_add)}


def bound_ms(nbytes, nops):
    """(least ms, "bytes" or "operations")."""
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = nops / PEAK_OPS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def _timed_from(flat, snap, nu, nu0, fn, reps):
    """Mean CUDA-event ms of fn() over `reps` calls, each on tables and
    n_unique restored from the snapshot first; the last call's result."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flat.copy_(snap)
        nu.copy_(nu0)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps, out


def time_window(dev, path=STAMPS, k=32, cutoff=20, x=1e6, n_tables=4,
                at=6, reps=10):
    """Window `at` of `path` (after windows 0..at-1 went through the
    port's ScanNormalizer): kernels E and F against their plain versions,
    times, bounds and mismatches. The window must pack as one run (reads
    of at most 4096 bases)."""
    cg = Countgraph(k, x, n_tables, device=dev)
    norm = ScanNormalizer(cg, cutoff)
    windows = list(itertools.islice(read_windows(path, k), at + 1))
    for w in windows[:at]:
        norm.process_window(w)
    bundles = windows[at]
    (_, _, L), = row_runs(bundles, k)
    codes, lengths = (torch.from_numpy(a).to(dev)
                      for a in pack_window(bundles, L))
    primes, flat, nu = cg._primes, cg.tables.flat, cg._n_unique
    snap, nu0 = flat.clone(), nu.clone()

    loads = torch.zeros(1, dtype=torch.int64, device=dev)
    reject = K.diginorm_med_cuda(primes, k, cutoff, flat, codes, lengths,
                                 loads)
    _, loaded = K.med_load_plan(primes, k, cutoff, flat, codes, lengths)
    windows = int(loaded[0].sum())
    med_err = (int((reject != K.med_ok_plain(primes, k, cutoff, flat, codes,
                                             lengths)).sum())
               + abs(int(loads) - int(loaded.sum())))

    def med():
        return K.diginorm_med_cuda(primes, k, cutoff, flat, codes, lengths)

    e_ms = cuda_ms(med, reps)
    e_dev = device_ms(med, reps)
    e_plain = cuda_ms(lambda: K.med_ok_plain(primes, k, cutoff, flat, codes,
                                             lengths), 3)

    f_ms, keep = _timed_from(
        flat, snap, nu, nu0, lambda: K.diginorm_scan_cuda(
            primes, k, cutoff, flat, nu, codes, lengths, reject), reps)
    f_tables, f_nu = flat.clone(), int(nu)
    f_plain, keep_p = _timed_from(
        flat, snap, nu, nu0, lambda: K.diginorm_window_plain(
            primes, k, cutoff, flat, nu, codes, lengths, reject), 1)
    scan_err = (int((keep != keep_p).sum()) + abs(f_nu - int(nu))
                + (0 if torch.equal(f_tables, flat) else 1))
    b = bounds(primes, k, codes, lengths, reject, keep, loaded)
    ncand = int((~reject).sum())
    return {
        "device": torch.cuda.get_device_name(dev), "window": at,
        "bundles": len(bundles), "L": L, "candidates": ncand,
        "kept": int(keep.sum()),
        "med": {"ms": e_ms, "device_ms": e_dev, "plain_ms": e_plain,
                "mismatches": med_err, "windows": windows,
                "loads": int(loads), "all_loads": windows * len(primes),
                "bytes": b["E"][0], "ops": b["E"][1],
                "bound": bound_ms(*b["E"][:2]),
                "sector_bytes": b["E"][2],
                "sector_ms": b["E"][2] / PEAK_BYTES_S * 1e3,
                "rule_sector_bytes": b["E"][3],
                "rule_sector_ms": b["E"][3] / PEAK_BYTES_S * 1e3},
        "scan": {"ms": f_ms, "plain_ms": f_plain, "mismatches": scan_err,
                 "us_per_candidate": f_ms * 1e3 / max(ncand, 1),
                 "bytes": b["F"][0], "ops": b["F"][1],
                 "bound": bound_ms(*b["F"])},
    }


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("diginorm_bench needs a CUDA device")
    print(json.dumps(time_window(torch.device(
        "cuda", torch.cuda.current_device()))))


if __name__ == "__main__":
    main()
