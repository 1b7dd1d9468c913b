"""Seeded trim-low-abund windows that hold kernels G and H
(csrc/trim_prepass.cu and csrc/trim_scan.cu, csrc/read_counts.cu) to their
plain versions.

``CASES`` names the windows and tables that chip_smoke.py phase 3 and
tests/test_torch_gpu_kernels.py run on the card: counters at 254 and 255,
cutoff 1, 2, 255 and 300, trim coverage (-Z) 20 and 300, --diginorm on and
off, k 20 and 32, one and 32 tables (a consumed bundle's adds in several
sub-chunks), rows of 64, 4096 and 20,000 codes, bundles whose read 1 is
shorter than k, a window where a consume lifts a later branch-1 bundle's
k-mer from cutoff - 1 to cutoff (``lift_window``: that bundle's trim
position moves), and the byte tables of 0.2 and 4 GB (PRIME_SETS of
scripts/byte_gather_bench.py). Four hold G's pre-pass and walk to the
sequential rule, in stream order: ``consume-lifts-trim`` (a bundle that
is no candidate, whose bad window an earlier consume lifts),
``consume-lifts-digi`` (with --diginorm, a bundle that is no candidate
moved from branch 1 to branch 0 by an earlier consume),
``consume-lifts-candidate`` (a candidate that an earlier consume lifts
past the trim coverage, so it is not consumed; both ``pair_window``) and
``groups-and-lone`` (live bundles across groups and a tile boundary,
short ones grouped, long ones alone, each repeated so later copies see
earlier adds). The windows come from
scripts/diginorm_cases.py's ``window``: reads drawn from a short random
genome, so k-mers repeat across and within bundles, with absent reads,
reads shorter than k and reads of exactly k among them.

``COUNT_CASES`` names the rows that hold kernel H alone to its plain
version on the shapes its tiles and segments meet: one row of 1,000,000
codes (the shape Countgraph.median_at_least sends for a 1 Mb sequence),
a long-read run as row_runs packs reads of 5,000-15,000 bases, rows of L
% 16 != 0 (no 16-byte loads past the first row) of one segment and of
several, short reads mixed with long ones in one matrix and a tile's tail
of rows, k = 1 and 32 with reads of 0, 1 and 2 windows, and counters at
254-255 under a bigcount table; each at several (cutoff, at_least),
either order, equal and 0 among them, with windows zeroed so that rows
turn bad at window 0, at a window of a later segment, or nowhere.

``check_case`` runs kernel G against trim_window_plain, each of its
launches (mark, probe, walk) against its plain version, and kernel H
against read_counts_plain on one case, H also with a bigcount table and
thresholds above 255; ``check_counts_case`` runs kernel H against
read_counts_plain on one of COUNT_CASES; ``check_long_window`` runs the
port's ScanTrimmerState on the card and on the CPU over windows holding
reads of 5,000 to 15,000 bases.

    python -m khmer_tpu_torch.scripts.trim_cases   # every case, on the card
"""

import json

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.diginorm_scan import LONG_RUN_BYTES
from khmer_tpu_torch.ops.u64 import umod
from khmer_tpu_torch.scripts.byte_gather_bench import PRIME_SETS
from khmer_tpu_torch.scripts.diginorm_cases import (BIG, MID, SMALL, _equal,
                                                    fill_tables,
                                                    repeated_window, window)

# name: (primes, table fill (None: zeros; (lo, hi, zero_below) as
# diginorm_cases.fill_tables takes it; "lift": lift_tables of the window;
# ("pair", shared, own): pair_tables), k, cutoff (-C), trim coverage (-Z),
# diginorm coverage (None: off), bundles, row length, genome length, window
# kind ("mixed": diginorm_cases.window; "short-mate": read 1 of every
# bundle shorter than k; "lift": lift_window; "pair": pair_window;
# "repeats+long": diginorm_cases.repeated_window, every fourth bundle
# drawn long))
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
    "consume-lifts-digi": (BIG, ("pair", 4, 0), 20, 2, 3, 5, 64, 128,
                           100000, "pair"),
    "consume-lifts-candidate": (BIG, ("pair", 2, 0), 20, 2, 3, None, 64,
                                128, 100000, "pair"),
    "groups-and-lone": ((100003, 100019, 100043), (2, 8, 0), 20, 3, 3,
                        None, 600, 2048, 20000, "repeats+long"),
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


# where pair_window's read B starts inside read A's span (codes)
PAIR_OFFSET = 10


def pair_window(rng, B, L, k, genome_len):
    """Pairs of single-read bundles from a random genome: bundle 2i holds a
    read A of L codes, bundle 2i + 1 a read of L / 2 codes that starts
    PAIR_OFFSET codes before A, so more than half of its windows are A's
    (its windows PAIR_OFFSET .. L / 2 - k) and fewer than half of A's are
    its. Pair i lies in genome[2 L i, 2 L (i + 1)), so pairs share no
    k-mer. pair_tables sets the counters of A's windows."""
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    codes = np.zeros((2 * B, L), dtype=np.uint8)
    lengths = np.zeros(2 * B, dtype=np.int32)
    half = L // 2
    for i in range(B // 2):
        s = 2 * L * i + int(rng.integers(0, L - PAIR_OFFSET))
        a, b = 4 * i, 4 * i + 2
        codes[a] = genome[s + PAIR_OFFSET:s + PAIR_OFFSET + L]
        lengths[a] = L
        codes[b, :half] = genome[s:s + half]
        lengths[b] = half
    return codes, lengths


def pair_tables(primes, k, shared, own, codes, lengths):
    """Flat tables (numpy uint8) for pair_window: LIFT_HIGH everywhere but
    the counters of the A reads' windows: `shared` for those the next read
    shares, `own` for the rest. With `own` below the trim coverage, each A
    is consumed and lifts the shared counters by one, which moves the next
    read across a threshold at `shared` + 1."""
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    hashes, valid, _ = K._window_hashes(c, n, k)
    flat = np.full(K.byte_flat_size(primes), LIFT_HIGH, dtype=np.uint8)
    rows = torch.arange(0, codes.shape[0], 4)
    L = codes.shape[1]
    nshared = L // 2 - k - PAIR_OFFSET + 1
    is_shared = torch.arange(L - k + 1) < nshared
    for value, part in ((own, ~is_shared), (shared, is_shared)):
        for p, o in zip(primes, K.byte_offsets(primes)):
            idx = (umod(hashes[rows], p) + o)[valid[rows] & part]
            flat[idx.numpy()] = value
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
    elif kind == "lift":
        codes, lengths = lift_window(rng, B, L, k, glen)
    elif kind == "pair":
        codes, lengths = pair_window(rng, B, L, k, glen)
    else:
        codes, lengths = repeated_window(rng, B, L, k, glen, long_every=4)
    if fill == "lift":
        fill = lift_tables(primes, k, C, codes, lengths)
    elif fill is not None and fill[0] == "pair":
        fill = pair_tables(primes, k, *fill[1:], codes, lengths)
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


def _mismatch(got, want):
    return sum(int((a != b).sum()) for a, b in zip(got, want))


def check_launches(primes, k, C, Z, D, flat, c, n):
    """Kernel G's launches one at a time on the card, each against its
    plain version on the same inputs, from tables `flat` (left as they
    were): {"mark": differing states, branches, trim positions and set
    words, "probe": differing states, "walk": differing branches and trim
    positions, plus 1 for tables that differ, plus the n_unique
    difference}, and the window's candidates, live bundles, groups, live
    bundles run alone and bundles whose branch the walk moved from the
    pre-pass's."""
    dev = flat.device
    B, W = c.shape[0] // 2, c.shape[1] - k + 1
    words = K.trim_plan(len(primes), B, W)["mark_words"]
    marks_k = torch.empty(words, dtype=torch.int32, device=dev)
    marks_p = torch.zeros_like(marks_k)
    out = {}
    got = K.trim_mark_cuda(primes, k, C, Z, D, flat, c, n, marks_k)
    want = K.trim_mark_plain(primes, k, C, Z, D, flat, c, n, marks_p)
    out["mark"] = _mismatch(got, want) + int((marks_k != marks_p).sum())
    state_k, state_p = got[0], want[0].clone()
    out["candidates"] = int((state_p == K.TRIM_LIVE).sum())
    K.trim_probe_cuda(primes, k, C, D, flat, c, n, marks_p, state_k)
    K.trim_probe_plain(primes, k, C, D, flat, c, n, marks_p, state_p)
    out["probe"] = int((state_k != state_p).sum())
    out["live"] = int((state_p == K.TRIM_LIVE).sum())
    flat_k, flat_p = flat.clone(), flat.clone()
    nu_k = torch.full((1,), 5, dtype=torch.int64, device=dev)
    nu_p = nu_k.clone()
    groups = torch.zeros(1, dtype=torch.int64, device=dev)
    walk_k = K.trim_walk_cuda(primes, k, C, Z, D, flat_k, nu_k, c, n,
                              state_p, *(t.clone() for t in want[1:]),
                              n_groups=groups)
    walk_p = K.trim_walk_plain(primes, k, C, Z, D, flat_p, nu_p, c, n,
                               state_p, *(t.clone() for t in want[1:]))
    torch.cuda.synchronize(dev)
    out["walk"] = (_mismatch(walk_k, walk_p)
                   + (0 if _equal(flat_k, flat_p) else 1)
                   + abs(int(nu_k) - int(nu_p)))
    out["groups"] = int(groups)
    # bundles whose branch the walk moved from the pre-pass's, and live
    # bundles too large for a group (the walk runs them alone)
    out["moved"] = int((walk_p[0] != want[1]).sum())
    nw = torch.clamp(n.to(torch.int64) - (k - 1), 0, W)
    big = (nw[0::2] + nw[1::2]) > K.trim_plan(len(primes))["group_events"]
    out["alone"] = int((big & (state_p == K.TRIM_LIVE)).sum())
    return out


def check_case(name, dev):
    """Case `name` on the card: kernel G against trim_window_plain from the
    same tables (branch, trim_at, tables, n_unique), each of G's launches
    against its plain version (check_launches), and kernel H against
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
    out.update(check_launches(primes, k, C, Z, D, flat_k, c, n))
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


# rows row_runs packs into one run of reads of up to 15,000 bases
LONG_RUN_ROWS = LONG_RUN_BYTES // (2 * 15000)
# (cutoff, at_least) pairs each count case runs at
THRESHOLDS = ((2, 20), (20, 2), (0, 0), (0, 5), (5, 0), (7, 7))
BIG_THRESHOLDS = ((300, 300), (255, 255), (256, 260), (2, 300))

# name: (primes, table fill (lo, hi), k, rows, row length, read lengths
# (lo, hi), reads of 0, 1 and 2 windows among them, a bigcount table)
COUNT_CASES = {
    "one row of 1,000,000 codes": (PRIME_SETS["config-1"], (3, 40), 20, 1,
                                   1_000_000, (1_000_000, 1_000_000),
                                   False, False),
    "long-read run": (PRIME_SETS["config-1"], (3, 40), 20, LONG_RUN_ROWS,
                      15000, (5000, 15000), False, False),
    "L=133 (L % 16 != 0)": (BIG, (3, 40), 20, 1000, 133, (1, 133), True,
                            False),
    "L=5003 (L % 16 != 0)": (BIG, (3, 40), 20, 41, 5003, (1, 5003), True,
                             False),
    "short and long reads mixed": (BIG, (3, 40), 20, 301, 15000, (30, 150),
                                   True, False),
    "short rows, a tile's tail": (BIG, (3, 40), 20, 53, 128, (1, 128), True,
                                  False),
    "k=1": (MID, (3, 40), 1, 300, 77, (0, 77), True, False),
    "k=32": (BIG, (3, 40), 32, 40, 4099, (1, 4099), True, False),
    "counters 254-255, bigcount": (BIG, (254, 255), 20, 60, 2000, (1, 2000),
                                   True, True),
}


def _kmer_hash(codes, k):
    """The canonical 2-bit hash of k codes (khmer_twobit::canonical)."""
    f = r = 0
    for i, c in enumerate(codes[:k]):
        f = (f << 2) | int(c)
        r |= (int(c) ^ 1) << (2 * i)
    return min(f, r)


def make_count_case(name, seed=20261101):
    """(primes, k, codes, lengths, fill, thresholds, big) of count case
    `name`: reads drawn from a random genome, long ones at the lengths the
    case gives and, in the short-and-long case, every tenth read long;
    fill is the flat tables (numpy uint8) with one table's counter of one
    window zeroed in three rows of every four, row 0 first: a window past
    the first segment (past window 0 where the read has one segment), any
    later window, none, window 0 (none for k < 8, whose few k-mers every
    row shares)."""
    primes, (lo, hi), k, R, L, (n_lo, n_hi), edges, big = COUNT_CASES[name]
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    genome = rng.integers(0, 4, max(L, 200_000) + 1, dtype=np.uint8)
    lens = rng.integers(n_lo, n_hi + 1, R)
    if L > n_hi:  # short reads with long ones among them
        lens[::10] = rng.integers(5000, L + 1, len(lens[::10]))
    if edges:  # reads of no window, of one and of two
        lens[1:9] = (0, k - 1, k, k + 1, k, k + 1, L, L)
    codes = np.zeros((R, L), dtype=np.uint8)
    for r, n in enumerate(lens):
        s0 = int(rng.integers(0, genome.shape[0] - n + 1))
        codes[r, :n] = genome[s0:s0 + n]
    fill = rng.integers(lo, hi + 1, K.byte_flat_size(primes),
                        dtype=np.uint8)
    seg = K.read_plan(L, k)["seg"]
    offsets = K.byte_offsets(primes)
    for r, n in enumerate(lens):
        nw, kind = n - k + 1, (r + 2) % 4
        if nw < 1 or kind == 0 or k < 8:  # 1-mers: all rows share them
            continue
        if kind == 1 or nw == 1:
            j = 0
        elif kind == 2:
            j = int(rng.integers(seg if nw > seg else 1, nw))
        else:
            j = int(rng.integers(1, nw))
        t = r % len(primes)
        fill[offsets[t] + _kmer_hash(codes[r, j:j + k], k) % primes[t]] = 0
    thresholds = THRESHOLDS + (BIG_THRESHOLDS if big else ())
    return primes, k, codes, lens.astype(np.int32), fill, thresholds, big


def check_counts_case(name, dev):
    """Count case `name` on the card: kernel H against read_counts_plain at
    each of the case's (cutoff, at_least), with its bigcount table where it
    has one (diginorm's big_table: counts of 255 to 600). Returns the
    differing outputs, the rows and the row length, the case's plan, and
    the rows whose trim position is 0 and those at their full length."""
    primes, k, codes, lengths, fill, thresholds, big = make_count_case(name)
    c = torch.from_numpy(codes).to(dev)
    n = torch.from_numpy(lengths).to(dev)
    flat = torch.from_numpy(fill).to(dev)
    table = big_table(primes, k, flat, c, n, dev) if big else None
    out = {"rows": codes.shape[0], "L": codes.shape[1],
           "plan": K.read_plan(codes.shape[1], k), "mismatches": 0,
           "trim 0": 0, "untrimmed": 0}
    for C, X in thresholds:
        got = K.read_counts_cuda(primes, k, C, X, flat, c, n, table)
        want = K.read_counts_plain(primes, k, C, X, flat, c, n, table)
        out["mismatches"] += _mismatch(got, want)
        out["trim 0"] += int((want[0] == 0).sum())
        out["untrimmed"] += int((want[0] == n).sum())
    del flat
    torch.cuda.empty_cache()
    return out


def check_long_window(dev, cutoff=2, trim_cov=3):
    """ScanTrimmerState on a countgraph on the card against one on the CPU
    (the plain versions) over diginorm_cases.long_read_windows: mismatched
    branches and trim positions, plus 1 for tables that differ, plus the
    n_unique, run-count, candidate, live and group differences; and
    kernel G's launches, which
    must be one a run (each of its three)."""
    from khmer_tpu_torch.core.diginorm_scan import ScanTrimmerState
    from khmer_tpu_torch.core.sketch import Countgraph
    from khmer_tpu_torch.scripts.diginorm_cases import long_read_windows

    engines = [ScanTrimmerState(Countgraph(20, 2e5, 3, device=d), cutoff,
                                trim_cov) for d in (dev, "cpu")]
    launchers = (K.trim_mark_cuda, K.trim_probe_cuda, K.trim_walk_cuda)
    before = [f.launches for f in launchers]
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
        + abs(card.scan_runs - cpu.scan_runs)
        + sum(abs(int(getattr(card, c)) - int(getattr(cpu, c)))
              for c in ("candidates", "live", "groups")))
    out["runs"] = card.scan_runs
    out["launches"] = tuple(f.launches - b
                            for f, b in zip(launchers, before))
    return out


def main():
    dev = torch.device("cuda", 0)
    failed = 0
    for name in CASES:
        got = check_case(name, dev)
        failed += (got["scan"] + got["counts"] + got["mark"]
                   + got["probe"] + got["walk"])
        print(json.dumps(dict(case=name, **got)), flush=True)
    for name in COUNT_CASES:
        got = check_counts_case(name, dev)
        failed += got["mismatches"]
        print(json.dumps(dict(case=name, **got)), flush=True)
    got = check_long_window(dev)
    failed += got["mismatches"]
    print(json.dumps(dict(case="long reads", **got)), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
