"""Seeded trim-low-abund windows that hold kernels G and H
(csrc/trim_scan.cu, csrc/read_counts.cu) to their plain versions.

``CASES`` names the windows and tables that chip_smoke.py phase 3 and
tests/test_torch_gpu_kernels.py run on the card: counters at 254 and 255,
cutoff 1, 2, 255 and 300, trim coverage (-Z) 20 and 300, --diginorm on and
off, k 20 and 32, one and 32 tables (a consumed bundle's adds in several
sub-chunks), rows of 64, 4096 and 20,000 codes, bundles whose read 1 is
shorter than k, a window where a consume lifts a later branch-1 bundle's
k-mer from cutoff - 1 to cutoff (``lift_window``: that bundle's trim
position moves), and the byte tables of 0.2 and 4 GB (PRIME_SETS of
scripts/byte_gather_bench.py). The windows come from
scripts/diginorm_cases.py's ``window``: reads drawn from a short random
genome, so k-mers repeat across and within bundles, with absent reads,
reads shorter than k and reads of exactly k among them.

``check_case`` runs kernel G against trim_window_plain and kernel H
against read_counts_plain on one case, H also with a bigcount table and
thresholds above 255; ``check_long_window`` runs the port's
ScanTrimmerState on the card and on the CPU over windows holding reads of
5,000 to 15,000 bases.

    python -m khmer_tpu_torch.scripts.trim_cases   # every case, on the card
"""

import json

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops.u64 import umod
from khmer_tpu_torch.scripts.byte_gather_bench import PRIME_SETS
from khmer_tpu_torch.scripts.diginorm_cases import (BIG, MID, SMALL, _equal,
                                                    fill_tables, window)

# name: (primes, table fill (None: zeros; (lo, hi, zero_below) as
# diginorm_cases.fill_tables takes it; "lift": lift_tables of the window),
# k, cutoff (-C), trim coverage (-Z), diginorm coverage (None: off),
# bundles, row length, genome length, window kind ("mixed": diginorm_cases
# .window; "short-mate": read 1 of every bundle shorter than k; "lift":
# lift_window))
CASES = {
    "C=1": (SMALL, None, 20, 1, 20, None, 128, 64, 300, "mixed"),
    "C=2-Z=20": (SMALL, (0, 30, 0), 20, 2, 20, None, 128, 64, 300, "mixed"),
    "counters-254-255": (SMALL, (254, 255, 0), 20, 255, 254, 255, 128, 64,
                         300, "mixed"),
    "C=255": (SMALL, (200, 255, 0), 20, 255, 20, None, 128, 64, 300,
              "mixed"),
    "C=300-Z=300": (SMALL, (254, 255, 0), 20, 300, 300, None, 128, 64, 300,
                    "mixed"),
    "diginorm": (MID, (0, 30, 0), 20, 2, 5, 10, 128, 64, 1500, "mixed"),
    "diginorm-Z=300": (MID, (0, 30, 0), 20, 2, 300, 10, 128, 64, 1500,
                       "mixed"),
    "k=32": (MID, None, 32, 2, 3, None, 128, 64, 400, "mixed"),
    "one-table": ((7919,), (0, 5, 0), 20, 2, 3, 4, 128, 128, 500, "mixed"),
    "32-tables-subchunks": (tuple(K.get_n_primes_near_x(32, 2000)), None,
                            20, 2, 2, None, 32, 512, 2000, "mixed"),
    "L=4096": ((100003, 100019), (0, 4, 0), 20, 2, 3, None, 8, 4096, 6000,
               "mixed"),
    "L=20000": ((100003, 100019, 100043), (0, 4, 0), 20, 2, 3, 6, 8, 20000,
                25000, "mixed"),
    "short-mate": (SMALL, (0, 5, 0), 20, 2, 3, None, 128, 64, 300,
                   "short-mate"),
    "consume-lifts-trim": (BIG, "lift", 20, 2, 2, None, 64, 128, 100000,
                           "lift"),
    "config-1": (PRIME_SETS["config-1"], (0, 40, 0), 20, 2, 20, None, 512,
                 128, 5000, "mixed"),
    "-x 1e9 -N 4": (PRIME_SETS["-x 1e9 -N 4"], (0, 40, 0), 20, 2, 20, 30,
                    512, 128, 5000, "mixed"),
}

# counters the lift window's consumed reads and the rest of the tables hold
LIFT_HIGH = 250


def short_mate_window(rng, B, L, k, genome_len):
    """Bundles of a read of k to L codes and a mate of 1 to k - 1 codes."""
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    codes = np.zeros((2 * B, L), dtype=np.uint8)
    lengths = np.zeros(2 * B, dtype=np.int32)
    for row in range(2 * B):
        n = int(rng.integers(k, L + 1) if row % 2 == 0
                else rng.integers(1, k))
        s = int(rng.integers(0, genome_len - n + 1))
        codes[row, :n] = genome[s:s + n]
        lengths[row] = n
    return codes, lengths


def lift_window(rng, B, L, k, genome_len):
    """Pairs of single-read bundles from a random genome: bundle 2i holds a
    read A of L / 2 codes, bundle 2i + 1 a read of L codes that starts L /
    4 codes before A, so its windows L / 4 .. 3 L / 4 - k are A's windows
    (fewer than half of its L - k + 1). Pair i lies in genome[2 L i, 2 L
    (i + 1)), so pairs share no k-mer. lift_tables puts A's counters at
    cutoff - 1."""
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    codes = np.zeros((2 * B, L), dtype=np.uint8)
    lengths = np.zeros(2 * B, dtype=np.int32)
    half, quarter = L // 2, L // 4
    for i in range(B // 2):
        s = 2 * L * i + quarter + int(rng.integers(0, L - quarter))
        a, b = 4 * i, 4 * i + 2
        codes[a, :half] = genome[s:s + half]
        lengths[a] = half
        codes[b, :L] = genome[s - quarter:s - quarter + L]
        lengths[b] = L
    return codes, lengths


def lift_tables(primes, k, cutoff, codes, lengths):
    """Flat tables (numpy uint8) for lift_window: LIFT_HIGH everywhere but
    the counters of the A reads' windows, which hold cutoff - 1. Each A
    has fewer than half its windows at the trim coverage (LIFT_HIGH is
    above it), so it is consumed and lifts its counters to cutoff; the read
    after it shares windows with it, is at coverage, and trims at its
    first shared window only if that consume did not come first."""
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    hashes, valid, _ = K._window_hashes(c, n, k)
    flat = np.full(K.byte_flat_size(primes), LIFT_HIGH, dtype=np.uint8)
    rows = torch.arange(0, codes.shape[0], 4)
    for p, o in zip(primes, K.byte_offsets(primes)):
        idx = (umod(hashes[rows], p) + o)[valid[rows]]
        flat[idx.numpy()] = cutoff - 1
    return flat


def make_case(name, seed=20261030):
    """(primes, k, cutoff, trim_cov, digi_cov, codes, lengths, fill) of
    case `name`; the tables are made on the card by
    diginorm_cases.fill_tables."""
    primes, fill, k, C, Z, D, B, L, glen, kind = CASES[name]
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    if kind == "mixed":
        codes, lengths = window(rng, B, L, k, glen)
    elif kind == "short-mate":
        codes, lengths = short_mate_window(rng, B, L, k, glen)
    else:
        codes, lengths = lift_window(rng, B, L, k, glen)
    if fill == "lift":
        fill = lift_tables(primes, k, C, codes, lengths)
    return primes, k, C, Z, D, codes, lengths, fill


def big_table(primes, k, flat, codes, lengths, dev, seed=7):
    """A bigcount table (sketch_kernels.bigcount_table) for a window: every
    other window whose min-over-tables count is 255, with counts of 255 to
    600 (so thresholds of 300 fall both ways), and as many hashes that are
    in no read."""
    c, n = codes.to(dev), lengths.to(dev)
    hashes, valid, _ = K._window_hashes(c, n, k)
    counts = K.byte_gather_plain(primes, flat, hashes)
    sat = hashes[valid & (counts == K.MAX_KCOUNT)].unique()[::2]
    rng = np.random.default_rng(seed)
    keys = np.concatenate([sat.cpu().numpy().view(np.uint64),
                           rng.integers(0, 2**64, sat.shape[0],
                                        dtype=np.uint64)])
    values = rng.integers(255, 601, keys.shape[0])
    return K.bigcount_table(dict(zip(keys.tolist(), values.tolist())), dev)


def check_case(name, dev):
    """Case `name` on the card: kernel G against trim_window_plain from the
    same tables (branch, trim_at, tables, n_unique), and kernel H against
    read_counts_plain on the window's rows under the window-start tables,
    at the case's (cutoff, trim coverage), then with a bigcount table at
    (300, 300). Returns the mismatches of each kernel (differing outputs,
    plus 1 for tables that differ, plus the n_unique difference), what the
    window held, and `lifted`: bundles whose trim positions differ from
    those under the window-start tables."""
    primes, k, C, Z, D, codes, lengths, fill = make_case(name)
    c = torch.from_numpy(codes).to(dev)
    n = torch.from_numpy(lengths).to(dev)
    flat_k = fill_tables(primes, fill, dev)
    out = {"bundles": codes.shape[0] // 2, "L": codes.shape[1]}
    # H first: it reads the window-start tables, which G then changes
    at_k = K.read_counts_cuda(primes, k, C, Z, flat_k, c, n)
    at_p = K.read_counts_plain(primes, k, C, Z, flat_k, c, n)
    big = big_table(primes, k, flat_k, c, n, dev)
    big_k = K.read_counts_cuda(primes, k, 300, 300, flat_k, c, n, big)
    big_p = K.read_counts_plain(primes, k, 300, 300, flat_k, c, n, big)
    out["counts"] = sum(int((x != y).sum())
                        for x, y in zip(at_k + big_k, at_p + big_p))
    out["big entries"] = int(big[0].shape[0])
    out["big moved"] = int((big_k[1] != at_k[1]).sum()) if Z == 300 else 0
    flat_p = flat_k.clone()
    nu_k = torch.full((1,), 5, dtype=torch.int64, device=dev)
    nu_p = nu_k.clone()
    br_k, tr_k = K.trim_scan_cuda(primes, k, C, Z, D, flat_k, nu_k, c, n)
    br_p, tr_p = K.trim_window_plain(primes, k, C, Z, D, flat_p, nu_p, c, n)
    torch.cuda.synchronize(dev)
    out["scan"] = (int((br_k != br_p).sum()) + int((tr_k != tr_p).sum())
                   + (0 if _equal(flat_k, flat_p) else 1)
                   + abs(int(nu_k) - int(nu_p)))
    out["branches"] = torch.bincount(br_k.long(), minlength=3).tolist()
    out["new"] = int(nu_k) - 5
    # trim positions the window-start tables would give (read_counts
    # returns 0 where the scan returns k - 1: reads shorter than k)
    start = torch.where(n >= k, at_p[0], k - 1).reshape(-1, 2)
    out["lifted"] = int((start != tr_k).any(dim=1).sum())
    del flat_k, flat_p
    torch.cuda.empty_cache()
    return out


def check_long_window(dev, cutoff=2, trim_cov=3):
    """ScanTrimmerState on a countgraph on the card against one on the CPU
    (the plain versions) over diginorm_cases.long_read_windows: mismatched
    branches and trim positions, plus 1 for tables that differ, plus the
    n_unique and run-count differences; and kernel G's launches, which
    must be one a run."""
    from khmer_tpu_torch.core.diginorm_scan import ScanTrimmerState
    from khmer_tpu_torch.core.sketch import Countgraph
    from khmer_tpu_torch.scripts.diginorm_cases import long_read_windows

    engines = [ScanTrimmerState(Countgraph(20, 2e5, 3, device=d), cutoff,
                                trim_cov) for d in (dev, "cpu")]
    before = K.trim_scan_cuda.launches
    out = {"mismatches": 0, "consumed": 0}
    for win in long_read_windows():
        (bk, tk), (bp, tp) = (e.process_window(win) for e in engines)
        out["mismatches"] += int((bk != bp).sum()) + int((tk != tp).sum())
        out["consumed"] += int((bk == 2).sum())
    card, cpu = engines
    out["mismatches"] += (
        (0 if torch.equal(card.graph.tables.flat.cpu(),
                          cpu.graph.tables.flat) else 1)
        + abs(card.graph.n_unique_kmers() - cpu.graph.n_unique_kmers())
        + abs(card.scan_runs - cpu.scan_runs))
    out["runs"] = card.scan_runs
    out["launches"] = K.trim_scan_cuda.launches - before
    return out


def main():
    dev = torch.device("cuda", 0)
    failed = 0
    for name in CASES:
        got = check_case(name, dev)
        failed += got["scan"] + got["counts"]
        print(json.dumps(dict(case=name, **got)), flush=True)
    got = check_long_window(dev)
    failed += got["mismatches"]
    print(json.dumps(dict(case="long reads", **got)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
