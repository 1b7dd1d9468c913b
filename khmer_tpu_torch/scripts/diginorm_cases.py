"""Seeded diginorm windows that hold kernels E and F (csrc/diginorm_med.cu,
csrc/diginorm_scan.cu) to their plain versions.

``window`` draws a window of read bundles from a short random genome, so
k-mers repeat across and within bundles; ``CASES`` names the windows and
tables that chip_smoke.py phase 3 and tests/test_torch_gpu_kernels.py run
on the card: counters at 254 and 255, C = 1, 255 and above 255, k = 32,
rows of 64 and 4096 codes, rows longer than 4096 (9000, where kernel F
keeps a bundle's hashes in shared memory, and 20000, where they go to a
device buffer), one and 32 tables (a bundle's adds in several
sub-chunks, one k-mer repeated across them), a window that phase A
rejects whole and one where it rejects nothing, and the byte tables of
PRIME_SETS (scripts/byte_gather_bench.py), up to 20 GB. The cases of
GROUP_CASES hold kernel F's groups (sketch_kernels.scan_groups) to the
sequential rule: a scan that read each group's counters as the group
found them would get each of them wrong (tests/test_torch_diginorm.py).
``repeated_window`` makes their windows: each bundle several times in a
row, so a later copy in the same group sees what the earlier one added.
The last five cases hold kernel E's tiling and its rounds of loads
(sketch_kernels.med_plan, med_load_plan): rows of exactly one segment and
of one window more, 32 tables, rows of a million codes (one round), and
reads whose table-0 survivors equal their threshold or fall one short
(``need_edge_tables``); check_case also holds E's load counter to
med_load_plan's.
``check_long_window`` runs the ScanNormalizer on the card and on the CPU
over windows that hold reads longer than 4096 bases.
"""

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops.u64 import umod
from khmer_tpu_torch.scripts.byte_gather_bench import PRIME_SETS


def window(rng, B, L, k, genome_len=300, all_present=False):
    """(codes uint8 [2B, L], lengths int32 [2B]): reads drawn from a
    random genome of `genome_len` bases. Row lengths mix absent reads,
    reads shorter than k, reads of exactly k and full rows (with
    `all_present`, every read has at least k codes); a sixth of the
    bundles are one read twice (a bundle on the same counters twice) and
    an eighth of the rows are all A (a read repeating one k-mer)."""
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    codes = np.zeros((2 * B, L), dtype=np.uint8)
    lengths = np.zeros(2 * B, dtype=np.int32)
    for row in range(2 * B):
        kind = int(rng.integers(2 if all_present else 0, 10))
        if kind == 0:
            n = 0
        elif kind == 1:
            n = int(rng.integers(1, k))
        elif kind == 2:
            n = k
        elif kind == 3:
            n = L
        else:
            n = int(rng.integers(k, L + 1))
        n = min(n, genome_len)
        s = int(rng.integers(0, genome_len - n + 1))
        codes[row, :n] = genome[s:s + n]
        lengths[row] = n
    for b in rng.choice(B, B // 6, replace=False):
        codes[2 * b + 1] = codes[2 * b]
        lengths[2 * b + 1] = lengths[2 * b]
    for row in rng.choice(2 * B, max(B // 8, 1), replace=False):
        codes[row] = 0
    return codes, lengths


def repeated_window(rng, B, L, k, genome_len, copies=3, long_every=0):
    """(codes, lengths) of B bundles from a random genome: each bundle
    drawn once and then repeated, `copies` times in a row in all. Read 0
    has 20-150 codes (at least k), read 1 the same or is absent; with
    `long_every`, read 0 of every long_every-th bundle drawn has L/2 to L
    codes, too many events for a group (it runs alone)."""
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    codes = np.zeros((2 * B, L), dtype=np.uint8)
    lengths = np.zeros(2 * B, dtype=np.int32)
    for i, b in enumerate(range(0, B, copies)):
        for row in (2 * b, 2 * b + 1):
            if row % 2 and rng.random() < 0.5:
                continue
            if long_every and i % long_every == long_every - 1 \
                    and row % 2 == 0:
                n = int(rng.integers(L // 2, L + 1))
            else:
                n = int(rng.integers(max(k, 20), min(L, 150) + 1))
            s = int(rng.integers(0, genome_len - n + 1))
            codes[row, :n] = genome[s:s + n]
            lengths[row] = n
        for c in range(b + 1, min(b + copies, B)):
            codes[2 * c:2 * c + 2] = codes[2 * b:2 * b + 2]
            lengths[2 * c:2 * c + 2] = lengths[2 * b:2 * b + 2]
    return codes, lengths


SMALL = (211, 223, 227)
MID = (1009, 1013, 1019)
BIG = (1000003, 1000033, 1000037)

# name: (primes, table fill (None: zeros; (lo, hi, zero_below): uniform
# counts in [lo, hi], those below zero_below then set to 0; "need-edge":
# need_edge_tables of the window), k, C,
# bundles, row length, genome length, every read present[, "repeats": the
# window of repeated_window, or "repeats+long": with every third bundle
# drawn long])
CASES = {
    "C=1": (SMALL, None, 17, 1, 128, 64, 300, False),
    "counters-254-255": (SMALL, (246, 255, 250), 20, 255, 128, 64, 300,
                         False),
    "C=300": (SMALL, None, 20, 300, 128, 64, 300, False),
    "k=32": ((1009, 1013, 1019), None, 32, 3, 128, 64, 400, False),
    "L=4096": ((100003, 100019), (0, 4, 0), 20, 3, 8, 4096, 6000, False),
    "L=9000": ((100003, 100019, 100043), (0, 4, 0), 20, 3, 8, 9000, 12000,
               False),
    "L=20000": ((100003, 100019, 100043), (0, 4, 0), 20, 3, 8, 20000,
                25000, False),
    "32-tables-subchunks": (tuple(K.get_n_primes_near_x(32, 2000)), None,
                            20, 5, 32, 512, 2000, False),
    "one-table": ((7919,), None, 20, 4, 128, 128, 500, False),
    "all-rejected": (SMALL, (255, 255, 0), 20, 20, 128, 64, 300, False),
    "none-rejected": (SMALL, None, 20, 20, 128, 64, 300, True),
    "config-1": (PRIME_SETS["config-1"], (0, 40, 0), 20, 20, 512, 128,
                 5000, False),
    "-x 1e9 -N 4": (PRIME_SETS["-x 1e9 -N 4"], (0, 40, 0), 20, 20, 512, 128,
                    5000, False),
    "-x 5e9 -N 4": (PRIME_SETS["-x 5e9 -N 4"], (0, 40, 0), 20, 20, 512, 128,
                    5000, False),
    # a copy is rejected only because the earlier copy, kept in the same
    # group, raised its counters from C - 1 to C
    "group-raises-to-C": (MID, (4, 4, 0), 20, 5, 128, 64, 2000, False,
                          "repeats"),
    # counters at 254 and 255 hit by several kept candidates of a group
    "group-254-255": (MID, (254, 255, 0), 20, 255, 128, 64, 2000, False,
                      "repeats"),
    # k-mers first seen by two kept candidates of a group: only the first
    # is new
    "group-first-seen-twice": (MID, None, 20, 20, 64, 64, 150, True),
    # rows of 9000 codes: short bundles grouped, long ones alone
    "L=9000-grouped-and-alone": ((100003, 100019, 100043), (2, 2, 0), 20, 3,
                                 24, 9000, 12000, False, "repeats+long"),
    # kernel E's tiles (sketch_kernels.med_plan): rows of exactly one
    # segment of MED_SEG windows and of one window more; 32 tables with
    # counts about C, so that its second round of loads runs
    "one-segment-rows": ((100003, 100019, 100043), (2, 6, 0), 20, 3, 8,
                         K.MED_SEG + 19, 3000, True),
    "two-segment-rows": ((100003, 100019, 100043), (2, 6, 0), 20, 3, 8,
                         K.MED_SEG + 20, 3000, True),
    "32-tables-staged": (tuple(K.get_n_primes_near_x(32, 2000)), (2, 6, 0),
                         20, 3, 32, 512, 2000, False),
    # rows of a million codes: too many window bits for two rows' shared
    # memory, so kernel E loads every table in one round
    "one-round-1M-rows": ((100003, 100019, 100043), (2, 6, 0), 20, 3, 1,
                          10**6, 10**6, True),
    # reads whose table-0 survivors equal their threshold, or fall one
    # short of it, and reads that pass table 0 but fail the last table
    # (need_edge_tables)
    "survivors-equal-need": (BIG, "need-edge", 20, 5, 64, 128, 50000, True),
}

GROUP_CASES = ("group-raises-to-C", "group-254-255",
               "group-first-seen-twice", "L=9000-grouped-and-alone")


def make_case(name, seed=20261020):
    """(primes, k, C, codes, lengths, fill) of case `name`; the tables are
    made on the card by fill_tables."""
    primes, fill, k, C, B, L, glen, present, *kind = CASES[name]
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    if kind:
        codes, lengths = repeated_window(
            rng, B, L, k, glen, long_every=3 if kind[0] == "repeats+long"
            else 0)
    else:
        codes, lengths = window(rng, B, L, k, glen, present)
    if fill == "need-edge":
        fill = need_edge_tables(primes, k, C, codes, lengths)
    return primes, k, C, codes, lengths, fill


def need_edge_tables(primes, k, C, codes, lengths):
    """Flat tables (numpy uint8) for a window of present reads: every table
    but table 0 at C; table 0 at C on the first `need` windows of each read
    (need: its threshold), one fewer on read 0 of bundles 1, 4, 7, ...,
    and 0 elsewhere; the last table at C - 1 on the first window of read 1
    of bundles 2, 5, 8, .... So, but for counters two windows share, both
    reads of bundles 0, 3, 6, ... pass with exactly the windows they need
    (the bundle is rejected), read 0 of bundles 1, 4, 7, ... fails on table
    0 (its mate's other tables are never loaded), and read 1 of bundles 2,
    5, 8, ... passes table 0 and fails on the last table."""
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    hashes, _, nvalid = K._window_hashes(c, n, k)
    need = K._min_required(nvalid).tolist()
    offsets = K.byte_offsets(primes)
    flat = np.full(K.byte_flat_size(primes), C, dtype=np.uint8)
    flat[:primes[0]] = 0
    first = (umod(hashes, primes[0]) + offsets[0]).numpy()
    last = (umod(hashes[:, 0], primes[-1]) + offsets[-1]).numpy()
    for row, want in enumerate(need):
        kind = (row // 2 % 3, row % 2)
        flat[first[row, :want - (kind == (1, 0))]] = C
        if kind == (2, 1) and want:
            flat[last[row]] = C - 1
    return flat


def fill_tables(primes, fill, dev, seed=0):
    """The flat byte tables of a case on `dev`."""
    size = K.byte_flat_size(primes)
    if isinstance(fill, np.ndarray):
        return torch.from_numpy(fill).to(dev)
    if fill is None:
        return torch.zeros(size, dtype=torch.uint8, device=dev)
    lo, hi, zero_below = fill
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randint(lo, hi + 1, (size,), dtype=torch.uint8,
                         device=dev, generator=gen)
    if zero_below:
        flat[flat < zero_below] = 0
    return flat


def _equal(a, b, piece=1 << 30):
    """torch.equal over slices of `piece` bytes: no temporary the size of
    a 20 GB table."""
    return all(torch.equal(a[i:i + piece], b[i:i + piece])
               for i in range(0, a.shape[0], piece))


def check_case(name, dev):
    """Case `name` on the card: kernel E against med_ok_plain and its load
    counter against med_load_plan, then kernel F against
    diginorm_window_plain twice, after E (with its rejections) and alone
    (no bundle rejected), from the same tables. Returns the mismatches of
    each kernel (rejections plus the load-count difference; keep flags,
    plus 1 for tables that differ, plus the n_unique, candidate-count and
    group-count differences) and what the window held."""
    primes, k, C, codes, lengths, fill = make_case(name)
    c = torch.from_numpy(codes).to(dev)
    n = torch.from_numpy(lengths).to(dev)
    B = codes.shape[0] // 2
    out = {"bundles": B, "med": 0, "scan": 0}
    for label in ("after E", "alone"):
        flat_k = fill_tables(primes, fill, dev)
        if label == "after E":
            loads = torch.zeros(1, dtype=torch.int64, device=dev)
            reject = K.diginorm_med_cuda(primes, k, C, flat_k, c, n, loads)
            want = K.med_ok_plain(primes, k, C, flat_k, c, n)
            _, loaded = K.med_load_plan(primes, k, C, flat_k, c, n)
            out["loads"], out["planned loads"] = int(loads), int(loaded.sum())
            out["med"] = (int((reject != want).sum())
                          + abs(out["loads"] - out["planned loads"]))
            out["rejected"] = int(reject.sum())
            reject_p = want
        else:
            reject = torch.zeros(B, dtype=torch.bool, device=dev)
            reject_p = None
        flat_p = flat_k.clone()
        nu_k = torch.full((1,), 5, dtype=torch.int64, device=dev)
        nu_p = nu_k.clone()
        cand_k = torch.zeros(1, dtype=torch.int64, device=dev)
        cand_p = cand_k.clone()
        groups_k = torch.zeros(1, dtype=torch.int64, device=dev)
        groups_p = groups_k.clone()
        keep_k = K.diginorm_scan_cuda(primes, k, C, flat_k, nu_k, c, n,
                                      reject, cand_k, groups_k)
        keep_p = K.diginorm_window_plain(primes, k, C, flat_p, nu_p, c, n,
                                         reject_p, cand_p, groups_p)
        torch.cuda.synchronize()
        out["scan"] += (int((keep_k != keep_p).sum())
                        + (0 if _equal(flat_k, flat_p) else 1)
                        + abs(int(nu_k) - int(nu_p))
                        + abs(int(cand_k) - int(cand_p))
                        + abs(int(groups_k) - int(groups_p)))
        out["kept " + label] = int(keep_k.sum())
        out["new " + label] = int(nu_k) - 5
        out["groups " + label] = int(groups_k)
        del flat_k, flat_p
        torch.cuda.empty_cache()
    return out


def long_read_windows(seed=20261021):
    """Three windows of single-read bundles from a 40,000-base genome:
    short reads (30-150 bases), with reads of 6,000, 12,000 and 15,000
    (side by side) and 5,000 bases among them, so row_runs splits each
    window into runs of short and long bundles."""
    from khmer_tpu_torch.io.fastx import Record

    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), 40000))
    out = []
    for w in range(3):
        lens = [int(n) for n in rng.integers(30, 150, 200)]
        lens[20], lens[90], lens[91], lens[199] = 6000, 12000, 15000, 5000
        window = []
        for i, n in enumerate(lens):
            s = int(rng.integers(0, len(genome) - n))
            r = Record("w%dr%d" % (w, i), genome[s:s + n])
            r.cleaned_seq = r.sequence
            window.append([r])
        out.append(window)
    return out


def check_long_window(dev, C=3):
    """ScanNormalizer on a countgraph on the card against one on the CPU
    (the plain versions) over long_read_windows: mismatched keep flags,
    plus 1 for tables that differ, plus the n_unique, kernel E load and
    window, candidate, group and run count differences; and the kernels'
    launches, which must be one of each a run."""
    from khmer_tpu_torch.core.diginorm_scan import ScanNormalizer
    from khmer_tpu_torch.core.sketch import Countgraph

    engines = [ScanNormalizer(Countgraph(20, 2e5, 3, device=d), C)
               for d in (dev, "cpu")]
    before = (K.diginorm_med_cuda.launches, K.diginorm_scan_cuda.launches)
    out = {"mismatches": 0, "kept": 0}
    for window in long_read_windows():
        got, want = (e.process_window(window) for e in engines)
        out["mismatches"] += sum(len(a) != len(b) for a, b in zip(got, want))
        out["kept"] += sum(1 for a in got if a)
    card, cpu = engines
    out["mismatches"] += (
        (0 if torch.equal(card.graph.tables.flat.cpu(),
                          cpu.graph.tables.flat) else 1)
        + abs(card.graph.n_unique_kmers() - cpu.graph.n_unique_kmers())
        + abs(int(card.med_loads) - int(cpu.med_loads))
        + abs(card.med_windows - cpu.med_windows)
        + abs(int(card.candidates) - int(cpu.candidates))
        + abs(int(card.groups) - int(cpu.groups))
        + abs(card.scan_runs - cpu.scan_runs))
    out["runs"] = card.scan_runs
    out["launches"] = (K.diginorm_med_cuda.launches - before[0],
                       K.diginorm_scan_cuda.launches - before[1])
    return out
