"""Seeded cases that hold kernels J (csrc/bit_update.cu, the Bloom-filter
update with per-event new flags) and K (csrc/hll_add.cu, murmur + HLL
register max) to their plain versions on the card.

``BIT_CASES`` (J): crowded bins, where one bucket holds more distinct
bits than its map and the kernel must split it; one hash repeated through
a whole batch; hashes >= 2^63; tables whose bits are already set, a few,
half or most of them; a valid mask that is not a prefix and nvalid < m,
also over tables with few or most bits set; an empty batch; bit indices
above 2^32 (four tables of about 1.5e9 bits); one table, eight and 32
(the probe's lane mask at its widest); chunks in sequence, and a chunk in
mid-stream that repeats k-mers of the chunk before it and k-mers new to
the stream, several times each. Between them they take both of J's
paths: the probe where its sample finds few enough of the lanes open
(sketch_kernels.BIT_PROBE_MAX_OPEN), every lane to the commit where it
finds more. ``check_bit_case`` runs a case through both versions from
the same tables and returns the largest difference in flags, n_unique and
table bytes, and the lanes the kernel's probe left open (its lane masks,
``probe_mask``) against bit_probe_plain's.

``HLL_CASES`` (K): p 4 (registers in shared memory), 14 (the default -e
0.01) and 18 (registers merged straight into device memory); k 4, 17,
20, 25, 31, 32 (the sliding 2-bit words at their widest), 33 and 64 (the
bytes rebuilt from the staged codes, with JAX's palindrome test on the
last 32 codes and the first 32's complements); palindromes planted in the
reads (at odd k, windows whose halves mirror around a middle code, which
the test must refuse); reads shorter than k, windows across read
boundaries, reads so short that most runs of a thread cross starts, a
start at offset 0 and none there (a read continued from the chunk
before), a chunk whose fill stops short of its codes, a chunk longer than
one tile of the kernel, read starts on a tile's first and last windows and
codes and on the edges of a thread's run, a last tile of one window, and
a chunk of one window. A register whose rho comes from h >> p == 0 cannot
be made from codes (it needs a murmur hash below 2^p);
sketch_kernels.hll_index_rho is held to that edge on the CPU
(tests/test_torch_hll.py). ``check_hll_case`` returns the largest register
difference.

Run on the card: python -m khmer_tpu_torch.scripts.graph_cases
"""

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K


def _bits(rng, primes, kind, m, before):
    """A batch of m u64 hashes (`before`: the case's batch before it)."""
    if kind == "mid":
        # 3/4 from the batch before, 1/4 new: each hash 4 times
        seen = before[rng.integers(0, before.shape[0], 3 * m // 16)]
        new = rng.integers(0, 2**64, m // 16, dtype=np.uint64)
        h = np.concatenate([seen, new]).repeat(4)[:m]
        return h[rng.permutation(m)]
    if kind == "crowded":
        prod = int(np.prod([int(p) for p in primes], dtype=object))
        low = rng.integers(0, 6000, m, dtype=np.uint64)
        if prod >= 2**63:
            return low
        mult = rng.integers(0, 2**64 // prod, m, dtype=np.uint64)
        return low + mult * np.uint64(prod)
    if kind == "repeat":
        return np.full(m, rng.integers(0, 2**64, dtype=np.uint64))
    h = rng.integers(0, 2**64, m, dtype=np.uint64)
    h[::2] |= np.uint64(1 << 63)
    return h


# name -> (primes, fill of the tables before the first batch: below 1 the
# share of bytes made random, from 1 on every byte the OR of that many
# random bytes (half of the bits set at 1, 7/8 at 3), [(kind, m, nvalid,
# masked)])
BIT_CASES = {
    "crowded-1-table": ((1_000_003,), 0.0, [("crowded", 4096, 4096, False)]),
    "crowded-4-tables": ((999_983, 999_979, 999_961, 999_959), 0.0,
                         [("crowded", 1 << 16, 1 << 16, False)] * 2),
    "one-hash-x2^20": ((49_999_991, 49_999_921), 0.0,
                       [("repeat", 1 << 20, 1 << 20, False)]),
    "high-hashes-8-tables": (
        (10_007, 10_009, 10_037, 10_039, 10_061, 10_067, 10_069, 10_079),
        0.0, [("full", 30_000, 30_000, False)] * 3),
    "bits-already-set": ((100_003, 100_019), 0.6,
                         [("full", 50_000, 50_000, False)]),
    "masked-nvalid": ((1_000_003, 999_983, 999_979), 0.0,
                      [("full", 65_536, 60_000, True),
                       ("full", 65_536, 1, True)]),
    "empty": ((1009, 1013), 0.1, [("full", 1000, 0, False),
                                  ("full", 0, 0, False)]),
    "past-2^32-bits": ((1_499_999_957, 1_499_999_929, 1_499_999_903,
                        1_499_999_897), 0.0,
                       [("full", 1 << 20, 1 << 20, False)] * 2),
    "half-set": ((1_000_003, 999_983, 999_979, 999_961), 1,
                 [("full", 1 << 18, 1 << 18, False)]),
    "mid-stream-repeats": ((2_000_003, 1_999_993, 1_999_979, 1_999_951),
                           0.0, [("full", 1 << 18, 1 << 18, False),
                                 ("mid", 1 << 18, 1 << 18, False)]),
    "masked-most-set": ((100_003, 100_019, 100_043), 3,
                        [("full", 40_000, 39_000, True)]),
    "masked-few-set": ((100_003, 100_019, 100_043), 0.3,
                       [("full", 40_000, 39_000, True)]),
    "32-tables": (tuple(K.get_n_primes_near_x(32, 100_000)), 0.0,
                  [("full", 20_000, 20_000, False)] * 2),
    "32-tables-most-set": (tuple(K.get_n_primes_near_x(32, 100_000)), 3,
                           [("full", 20_000, 20_000, False)]),
}


def bit_case_batches(name, seed=0):
    """(primes, initial table bytes as a numpy array of the flat buffer,
    [(hashes u64, valid bool or None, nvalid)])."""
    primes, fill, batches = BIT_CASES[name]
    rng = np.random.default_rng(seed)
    flat = np.zeros(K.bit_flat_size(primes), np.uint8)
    if fill >= 1:
        for _ in range(fill):
            flat |= rng.integers(0, 256, flat.shape[0], dtype=np.uint8)
    elif fill:
        dense = rng.random(flat.shape[0]) < fill
        flat[dense] = rng.integers(0, 256, int(dense.sum()), dtype=np.uint8)
    out = []
    h = np.zeros(0, np.uint64)
    for kind, m, nvalid, masked in batches:
        h = _bits(rng, primes, kind, m, h)
        valid = rng.random(m) < 0.8 if masked else None
        out.append((h, valid, nvalid))
    return primes, flat, out


def probe_mask(scratch, n, ntables):
    """The lane masks that kernel J's probe wrote for the n events of its
    last call on `scratch` (bit_update_cuda's scratch), int64 [n]: the
    min_old part of update_plan(n, ntables), as bit_probe_plain gives
    them."""
    off = K.update_plan(n, ntables)[1]["min_old"][0]
    words = scratch[off:off + 4 * n].view(torch.int32)
    return words.to(torch.int64) & 0xFFFFFFFF


def check_bit_case(name, dev):
    """Kernel J against bit_update_plain on `dev` over the case's batches
    in sequence: the largest difference of flags, n_unique, tables and the
    lanes its probe left open (bit_probe_plain's)."""
    primes, flat, batches = bit_case_batches(name)
    tk = K.BitTables(torch.from_numpy(flat).to(dev), primes)
    tp = K.BitTables(tk.flat.clone(), primes)
    nk = torch.zeros(1, dtype=torch.int64, device=dev)
    np_ = nk.clone()
    err = 0
    for h, valid, nvalid in batches:
        hd = torch.from_numpy(h.view(np.int64).copy()).to(dev)
        vd = None if valid is None else torch.from_numpy(valid).to(dev)
        lanes = K.bit_open_lanes(K.bit_probe_plain(primes, tp.flat, hd,
                                                   nvalid, vd))
        scratch = K.update_scratch(None, nvalid, len(primes), dev)
        fk = K.bit_update_cuda(primes, tk, nk, hd, nvalid, vd, scratch)
        fp = K.bit_update_plain(primes, tp, np_, hd, nvalid, vd)
        opened = K.bit_open_lanes(probe_mask(scratch, nvalid, len(primes)))
        err = max(err, int((fk != fp).sum()), abs(int(nk) - int(np_)),
                  int((tk.flat != tp.flat).sum()), abs(opened - lanes))
    return err


def _read_codes(rng, lengths, k, palindromes):
    """Seeded reads of the given lengths; with `palindromes`, one window a
    read that long is its own reverse complement (at odd k, whose middle
    code cannot be, the rest of it mirrors)."""
    reads = []
    for n in lengths:
        r = rng.integers(0, 4, int(n), dtype=np.uint8)
        if palindromes and n >= k:
            half = rng.integers(0, 4, k // 2, dtype=np.uint8)
            mid = rng.integers(0, 4, k % 2, dtype=np.uint8)
            at = int(rng.integers(0, n - k + 1))
            r[at:at + k] = np.concatenate([half, mid, (half ^ 1)[::-1]])
        reads.append(r)
    return reads


def _edge_lengths(k):
    """Read lengths whose starts fall on kernel K's edges: a thread's run
    (HLL_RUN windows), a tile's first and last windows (HLL_TILE a tile),
    the last code of the tile's first window, and the codes of its last
    window and past it, which the tile stages for that window."""
    T, R = K.HLL_TILE, K.HLL_RUN
    at = sorted({5 * R, 5 * R + 1, 7 * R - 1, T - 1, T, T + 1, T + k - 1,
                 2 * T - 1, 2 * T + k - 2, 2 * T + k - 1, 2 * T})
    return np.diff([0] + at + [3 * T + 50])


# name -> (p, k, read lengths' range, reads, extra codes past the fill,
# whether the chunk starts with a read continued from the chunk before);
# with reads None, the lengths are given whole
HLL_CASES = {
    "p4-k4": (4, 4, (0, 40), 300, 0, False),
    "p14-k17": (14, 17, (0, 200), 400, 0, False),
    "p14-k20-palindromes": (14, 20, (18, 120), 2000, 37, True),
    "p14-k31-short-tail": (14, 31, (0, 90), 500, 1000, True),
    "p14-k32-palindromes": (14, 32, (30, 300), 300, 0, False),
    "p18-k20": (18, 20, (0, 160), 20_000, 0, True),
    "p18-k32-palindromes": (18, 32, (0, 600), 3000, 5, False),
    "p14-k20-one-read-x8-tiles": (14, 20, (16_000, 16_001), 1, 0, False),
    "p14-k33-palindromes": (14, 33, (30, 200), 400, 0, False),
    "p18-k64-palindromes": (18, 64, (60, 400), 300, 3, True),
    "p4-k20-short-reads": (4, 20, (0, 45), 3000, 0, False),
    "p14-k20-tile-edges": (14, 20, _edge_lengths(20), None, 0, False),
    "p18-k25-tile-edges": (18, 25, _edge_lengths(25), None, 7, True),
    "p14-k20-one-window-tile": (14, 20, [K.HLL_TILE + 20], None, 0,
                                False),
    "p4-k25-one-window": (4, 25, [25], None, 0, False),
}


def hll_case_chunk(name, seed=0):
    """(p, k, codes uint8, starts int64, fill) of a case."""
    p, k, spread, nreads, extra, continued = HLL_CASES[name]
    rng = np.random.default_rng(seed + p * 100 + k)
    lengths = (np.asarray(spread, dtype=np.int64) if nreads is None
               else rng.integers(spread[0], spread[1], nreads))
    reads = _read_codes(rng, lengths, k, "palindromes" in name)
    codes = np.concatenate(reads + [rng.integers(0, 4, extra,
                                                 dtype=np.uint8)])
    starts = (np.cumsum(lengths) - lengths).astype(np.int64)
    if continued:
        starts = starts[1:]  # the first read began in an earlier chunk
    fill = int(lengths.sum())
    # padding past the fill, as FlatPacker's starts have
    starts = np.concatenate([starts, np.full(5, fill, np.int64)])
    return p, k, codes, starts, fill


def check_hll_case(name, dev):
    """Kernel K against hll_add_plain on `dev`, twice in a row (the
    second add over registers already set): the largest register
    difference."""
    p, k, codes, starts, fill = hll_case_chunk(name)
    cd = torch.from_numpy(codes).to(dev)
    sd = torch.from_numpy(starts).to(dev)
    rk = torch.zeros(1 << p, dtype=torch.uint8, device=dev)
    rp = rk.clone()
    err = 0
    for _ in range(2):
        K.hll_add_cuda(rk, cd, sd, fill, k)
        K.hll_add_plain(rp, cd, sd, fill, k)
        err = max(err, int((rk.to(torch.int32)
                            - rp.to(torch.int32)).abs().max()))
    return err


def hll_ops(k, windows):
    """The 32-bit integer operations the function needs for `windows`
    valid windows of k bases, a 64-bit multiply counted as 4 and every
    other 64-bit operation as 2: two MurmurHash3 x64-128 of k bytes (each
    16-byte block 6 multiplies and 18 other operations, each tail word 2
    and 4, the finalization 4 and 17), the palindrome test (one 64-bit
    compare), the register's index, rho and max (10), and upkeep of O(1)
    a window: each strand's 2-bit word (3 64-bit operations) and its byte
    window (2), and the read-start test (2). Kernel K's own rebuilding of
    a window's bytes and words from its k codes is not counted."""
    nblocks, tail = divmod(k, 16)
    tails = (tail > 8) + (tail > 0)
    muls = 6 * nblocks + 2 * tails + 4
    other = 18 * nblocks + 4 * tails + 17
    per_hash = 4 * muls + 2 * other
    return windows * (2 * per_hash + 2 + 10 + 2 * (2 * 3 + 2 * 2) + 2)


def main():
    dev = torch.device("cuda", 0)
    for name in BIT_CASES:
        print("bit", name, check_bit_case(name, dev))
    for name in HLL_CASES:
        print("hll", name, check_hll_case(name, dev))


if __name__ == "__main__":
    main()
