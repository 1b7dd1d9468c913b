"""Kernels P, Q and R (csrc/nibble_update.cu khmer_nibble_update,
csrc/nibble_gather.cu khmer_nibble_gather, khmer_nibble_pertable and
their rows modes khmer_nibble_row_counts and khmer_nibble_pertable_rows)
against their plain versions (core/sketch_kernels.py nibble_update_plain,
nibble_gather_plain, nibble_pertable_plain, nibble_row_counts_plain,
nibble_pertable_rows_plain) on seeded adversarial cases, on the card:
hashes >= 2^63 and at the edges of the reduction by a reciprocal;
in-chunk duplicates and one hash 2^20 times, counters driven past 15;
both nibbles of a byte in one chunk, and the two nibbles of a byte on
either side of an edge of kernel A's counter-range buckets; all 8 nibbles
of 32-bit words in one chunk; the first and last words of P's word
buckets (sketch_kernels.nibble_buckets); tiny odd primes (tables of two
to four bytes); a crowded bucket; a bucket whose records and distinct
nibbles exceed a block's shared memory many times over, which P takes in
parts and dense passes; one table and twenty; zero-padded tails; and
nibble tables of 0.1, 2, 4 and 20 GB, the 20 GB case also with a call of
1,000 events (P's fewest buckets, so its widest bucket offsets) where the
card has the memory. Each case commits its chunks through P and through
the plain version from the same tables (tables, n_unique and each event's
new flag compared after every chunk), then gathers its hashes and others
through Q (unmasked, and under a random, an all-false and an all-true
mask) and R. The row cases (ROW_CASES) hold both rows modes to their
plain versions on tables of random bytes: k 1, 20 and 32, rows of L % 16
!= 0 with reads shorter than k and empty rows, tables that share 32-bit
words, a read over 4,096 bases among short ones, a row of 1,000,000 codes
and a window of 16,384 reads in rows of 128 over 4 GB. chip_smoke.py
phase 3 and tests/test_torch_gpu_kernels.py run them.

    python -m khmer_tpu_torch.scripts.nibble_cases
"""

import functools

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.scripts.byte_gather_bench import reduction_edges

CHUNK = 1 << 20  # core/pipeline.py DENSE_CHUNK

# name -> (tables, each prime near, chunks, events a chunk, kind of hash)
NIBBLE_CASES = {
    "over-2^63": (4, 1e5, 3, 100_003, "top"),
    "reduction-edges": (3, 1e6, 2, 65_536, "edges"),
    "duplicates-past-15": (4, 1e4, 4, 65_536, "duplicates"),
    "one-hash-x2^20": (4, 1e5, 2, CHUNK, "one"),
    "both-nibbles-one-chunk": (2, 1e5, 3, 65_536, "pairs"),
    "both-nibbles-two-buckets": (2, 2e5, 3, 1 << 17, "straddle"),
    "tiny-odd-primes": (3, 8, 3, 4096, "random"),
    "crowded-bucket": (2, 1e6, 2, 1 << 18, "crowded"),
    "all-8-nibbles-a-word": (2, 1e5, 3, 65_536, "octets"),
    "words-at-bucket-edges": (2, 2e5, 3, 1 << 17, "word-edges"),
    "overflowing-bucket": (4, 1e8, 2, 1 << 18, "spread"),
    "one-table": (1, 1e6, 2, 100_003, "random"),
    "twenty-tables": (20, 1e4, 2, 30_001, "random"),
    "zero-padded-tail": (4, 1e5, 3, 65_536, "tail"),
    "0.1-GB": (4, 5e7, 2, CHUNK, "random"),
    "2-GB": (4, 1e9, 2, CHUNK, "random"),
    "4-GB": (4, 2e9, 2, CHUNK, "random"),
    "20-GB": (4, 1e10, 2, CHUNK, "small-last"),
}
SMALL_CALL = 1000  # events of the "small-last" cases' last call
SPREAD = 1 << 16  # the "spread" case's table-0 counters lie below this


def _straddling(primes, n, ntables):
    """Table-0 bins 2j + 1 whose nibble starts one of kernel A's buckets
    (core/sketch_kernels.py update_plan and bucket_of over the flat
    nibbles), which P used before its buckets were cut on words: the
    byte's high nibble, bin 2j, lies in the bucket before."""
    nbuckets = K.update_plan(n, ntables)[0]
    size = 2 * K.nibble_flat_size(primes)
    q = (2**64 - 1) // size
    out = []
    for b in range(1, nbuckets):
        # the first nibble of bucket b: bucket_of is monotone
        lo, hi = 0, size
        while lo < hi:
            mid = (lo + hi) // 2
            if (mid * q * nbuckets) >> 64 < b:
                lo = mid + 1
            else:
                hi = mid
        if lo % 2 == 1 and lo < primes[0]:
            out.append(lo)
    return np.asarray(out, dtype=np.uint64)


def _word_edges(primes, n, ntables):
    """Table-0 bins of every nibble of the first and the last word of each
    of P's buckets (sketch_kernels.nibble_update_plan, nibble_buckets) that
    lies in table 0."""
    nbuckets = K.nibble_update_plan(n, ntables)[0]
    span, used = K.nibble_buckets(K.nibble_flat_size(primes), nbuckets)
    words = np.concatenate([np.arange(used) * span,
                            np.arange(1, used + 1) * span - 1])
    bins = (8 * words[:, None] + np.arange(8)).ravel()
    return bins[bins < primes[0]].astype(np.uint64)


def _on_bins(bins, p0, rng):
    """A hash for each table-0 bin, shuffled."""
    j = rng.integers(0, 2**63 // int(p0), bins.shape[0], dtype=np.uint64)
    h = bins + j * p0
    return h[rng.permutation(h.shape[0])]


def _chunk_hashes(name, primes, c, m, rng):
    """(hashes u64 [m], nvalid) of chunk c of a case."""
    kind = NIBBLE_CASES[name][4]
    p0 = np.uint64(primes[0])
    if kind == "top":
        h = rng.integers(2**63, 2**64, m, dtype=np.uint64)
        h[:8] = np.uint64(2**64 - 1) - np.arange(8, dtype=np.uint64)
    elif kind == "edges":
        e = reduction_edges(primes, 0)
        h = np.concatenate([e, rng.integers(0, 2**64, m - len(e),
                                            dtype=np.uint64)])
    elif kind == "duplicates":
        pool = rng.integers(0, 2**64, 500, dtype=np.uint64)
        h = pool[rng.integers(0, 500, m)]
    elif kind == "one":
        h = np.full(m, np.uint64(0xC0FFEE) << np.uint64(40))
    elif kind in ("pairs", "straddle"):
        if kind == "pairs":
            bins = 2 * rng.integers(0, int(p0) // 2, m // 2).astype(
                np.uint64)
            bins = np.stack([bins, bins + np.uint64(1)], 1).ravel()
        else:
            odd = _straddling(primes, m, len(primes))
            pick = odd[rng.integers(0, len(odd), m // 2)]
            bins = np.stack([pick - np.uint64(1), pick], 1).ravel()
        j = rng.integers(0, 2**63 // int(p0), bins.shape[0],
                         dtype=np.uint64)
        h = bins + j * p0
        h = h[rng.permutation(h.shape[0])]
    elif kind == "octets":
        words = rng.integers(0, (int(p0) - 7) // 8, m // 8).astype(
            np.uint64)
        h = _on_bins((8 * words[:, None]
                      + np.arange(8, dtype=np.uint64)).ravel(), p0, rng)
    elif kind == "word-edges":
        edges = _word_edges(primes, m, len(primes))
        h = _on_bins(edges[rng.integers(0, len(edges), m)], p0, rng)
    elif kind == "spread":
        low = rng.integers(0, SPREAD, m, dtype=np.uint64)
        j = rng.integers(0, 2**64 // int(p0) - 1, m, dtype=np.uint64)
        h = low + j * p0
    elif kind == "crowded":
        low = rng.integers(0, 4096, m, dtype=np.uint64)
        j = rng.integers(0, 2**64 // int(p0) - 1, m, dtype=np.uint64)
        h = low + j * p0
    else:
        h = rng.integers(0, 2**64, m, dtype=np.uint64)
    nvalid = h.shape[0]
    if kind == "tail":
        nvalid = m - 4099 * (c + 1)
        h[nvalid:] = 0
    if kind == "small-last" and c == NIBBLE_CASES[name][2] - 1:
        nvalid = SMALL_CALL
        h[nvalid:] = 0
    return h, nvalid


def case_fits(name, dev):
    """Whether the card has the memory for a case: its tables, their copy
    and room for the plain version (half the tables again, at least 4
    GB)."""
    size = K.nibble_flat_size(case_primes(name))
    return torch.cuda.mem_get_info(dev)[0] >= 2 * size + max(size // 2,
                                                             4 << 30)


@functools.cache
def case_primes(name):
    """The primes of a case's tables."""
    return tuple(K.get_n_primes_near_x(*NIBBLE_CASES[name][:2]))


def case_tables(name, dev):
    """(primes, zeroed nibble tables on `dev`) of a case."""
    primes = case_primes(name)
    return primes, K.init_tables("nibble", primes, dev)


def _err(a, b):
    return int((a.int() - b.int()).abs().max()) if a.numel() else 0


def check_nibble_case(name, dev):
    """{"nibble_update", "nibble_gather", "nibble_pertable": the largest
    difference between the kernel and its plain version} on a case (all
    0 when they agree); the update's tables compared whole after each
    chunk, its n_unique and new flags with them."""
    primes, tables = case_tables(name, dev)
    m = NIBBLE_CASES[name][3]
    rng = np.random.default_rng(len(name) * 7919)
    flat_p = tables.flat.clone()
    nu_k = torch.zeros(1, dtype=torch.int64, device=dev)
    nu_p = nu_k.clone()
    errs = {"nibble_update": 0, "nibble_gather": 0, "nibble_pertable": 0}
    seen = []
    for c in range(NIBBLE_CASES[name][2]):
        h, nvalid = _chunk_hashes(name, primes, c, m, rng)
        ht = torch.from_numpy(h.view(np.int64).copy()).to(dev)
        got = K.nibble_update_cuda(primes, tables.flat, nu_k, ht, nvalid,
                                   with_event_new=True)
        want = K.nibble_update_plain(primes, flat_p, nu_p, ht, nvalid,
                                     with_event_new=True)
        err = max(_err(got, want), abs(int(nu_k) - int(nu_p)))
        if not torch.equal(tables.flat, flat_p):
            diff = (tables.flat != flat_p).nonzero()[0]
            err = max(err, _err(tables.flat[diff], flat_p[diff]), 1)
        errs["nibble_update"] = max(errs["nibble_update"], err)
        seen.append(h[:nvalid][:4096])
        del flat_p
        flat_p = tables.flat.clone()
    q = np.concatenate(seen + [reduction_edges(primes, 20_000)])
    qt = torch.from_numpy(q.view(np.int64).copy()).to(dev)
    for mask in (None, torch.from_numpy(rng.random(q.shape[0]) < 0.3).to(
            dev), torch.zeros(q.shape[0], dtype=torch.bool, device=dev),
            torch.ones(q.shape[0], dtype=torch.bool, device=dev)):
        errs["nibble_gather"] = max(errs["nibble_gather"], _err(
            K.nibble_gather_cuda(primes, tables.flat, qt, mask),
            K.nibble_gather_plain(primes, tables.flat, qt, mask)))
    errs["nibble_pertable"] = _err(
        K.nibble_pertable_cuda(primes, tables.flat, qt),
        K.nibble_pertable_plain(primes, tables.flat, qt))
    del flat_p, tables
    return errs


# name -> (tables, each prime near, k, rows): kernel R's and Q's rows modes
ROW_CASES = {
    "k1": (4, 1e5, 1, "short"),
    "k20-odd-rows": (4, 1e5, 20, "odd"),
    "k32": (4, 1e5, 32, "short"),
    "tiny-odd-primes": (3, 8, 20, "odd"),
    "straddling-words": (2, 2e5, 32, "odd"),
    "long-read": (4, 1e6, 20, "long"),
    "million-code-row": (4, 1e6, 32, "million"),
    "4-GB-window": (4, 2e9, 32, "window"),
}
# rows -> (B, L) of its code matrix
ROW_SHAPES = {"short": (64, 64), "odd": (67, 131), "long": (41, 5003),
              "million": (2, 1_000_000), "window": (16384, 128)}


def row_codes(rows, k, rng):
    """(codes uint8 [B, L], lengths int32 [B]) of a row case: "short",
    64 rows of 64 codes with lengths 0 to 64; "odd", 67 rows of 131 (L % 16
    != 0) with lengths 0, k - 1, k, L and between; "long", 40 reads of 100
    and one of 5,003 in rows of 5,003; "million", a row of 1,000,000 codes
    and one of 517; "window", 16,384 reads of 100 in rows of 128 (phase
    13b's normalize window)."""
    B, L = ROW_SHAPES[rows]
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    if rows == "short":
        lengths = rng.integers(0, L + 1, B)
    elif rows == "odd":
        lengths = np.concatenate([[0, k - 1, k, L, L - 1, k + 1],
                                  rng.integers(0, L + 1, B - 6)])
    elif rows == "long":
        lengths = np.full(B, 100)
        lengths[17] = L
    elif rows == "million":
        lengths = np.array([L, 517])
    else:
        lengths = np.full(B, 100)
    lengths = lengths.astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return codes, lengths


def row_case(name, dev):
    """(primes, flat: tables of random bytes, codes, lengths, k) of a row
    case on `dev`."""
    ntables, near, k, rows = ROW_CASES[name]
    primes = tuple(K.get_n_primes_near_x(ntables, near))
    rng = np.random.default_rng(len(name) * 104729)
    codes, lengths = row_codes(rows, k, rng)
    gen = torch.Generator(dev).manual_seed(len(name))
    flat = torch.randint(0, 256, (K.nibble_flat_size(primes),),
                         dtype=torch.uint8, device=dev, generator=gen)
    return (primes, flat, torch.from_numpy(codes).to(dev),
            torch.from_numpy(lengths).to(dev), k)


def row_case_fits(name, dev):
    """Whether the card has the memory for a row case: its tables, and 24
    B a window a table for the outputs and the plain version."""
    ntables, near, k, rows = ROW_CASES[name]
    size = K.nibble_flat_size(tuple(K.get_n_primes_near_x(ntables, near)))
    B, L = ROW_SHAPES[rows]
    return torch.cuda.mem_get_info(dev)[0] >= size + 64 * ntables * B * L


def check_row_case(name, dev):
    """{"nibble_pertable_rows", "nibble_row_counts": the largest difference
    between the rows mode and its plain version} on a row case (0 when they
    agree: hashes, counters and flat nibble indices; counts)."""
    primes, flat, codes, lengths, k = row_case(name, dev)
    got = K.nibble_pertable_rows_cuda(primes, flat, codes, lengths, k)
    want = K.nibble_pertable_rows_plain(primes, flat, codes, lengths, k)
    errs = {"nibble_pertable_rows": max(
        int(not torch.equal(got[0], want[0])), _err(got[1], want[1]),
        int(not torch.equal(got[2], want[2]))),
        "nibble_row_counts": _err(
            K.nibble_row_counts_cuda(primes, flat, codes, lengths, k),
            K.nibble_row_counts_plain(primes, flat, codes, lengths, k))}
    del got, want, flat
    return errs


def main():
    dev = torch.device("cuda", 0)
    for name in NIBBLE_CASES:
        if not case_fits(name, dev):
            print(name, "skipped: the card lacks the memory", flush=True)
            continue
        print(name, check_nibble_case(name, dev), flush=True)
        torch.cuda.empty_cache()
    for name in ROW_CASES:
        if not row_case_fits(name, dev):
            print(name, "skipped: the card lacks the memory", flush=True)
            continue
        print(name, check_row_case(name, dev), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
