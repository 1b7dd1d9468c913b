"""Seeded cases that hold the sketch family's kernels to their plain
versions, exactly: kernel S (csrc/consume_filter.cu, consume_filter_cuda
against consume_filter_plain) and kernel N's nibble mode
(csrc/neighbors.cu khmer_nibble_neighbors, nibble_neighbors_cuda against
nibble_neighbors_plain).

S's cases are chunks of hashes with a band, a mask's counts or both:
every hash kept and none; hashes on the band's edges (lo - 1, lo, hi - 1
and hi); a nibble mask's counts at thresholds 0 and 15, both ways; a bit
mask's 0/1 counts; a chunk of 2^20 whose one kept hash is its last; a
chunk whose padding past nvalid lies in the band; 100,003 hashes (not a
whole number of S's tiles) and 2^22 (more tiles than one round of its
scan). The counts are the plain gathers' of seeded tables.

N's nibble cases are nibble tables and a batch of nodes: k 1, 20 and 32,
1, 4 and 7 tables, tiny odd primes (a node's neighbours share the bytes
of a table, in both nibbles), random nibbles 60% set, 0.4% set, every
counter at 15, and the graph of seeded reads counted 1 to 3 times; levels
of 1, 31, 33 and 2,048 nodes and 100,003; each in both modes (small-level
and staged), without a band and at every band of NIBBLE_BANDS. On the
card (chip_smoke.py phase 3 and tests/test_torch_gpu_kernels.py run them):

    python -m khmer_tpu_torch.scripts.family_cases
"""

import json

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops.hashing import compute_band_interval

CHUNK = 1 << 20  # core/pipeline.py DENSE_CHUNK
U64 = 2**64

# name -> (hashes, nvalid (None: all), band ("bands", num, band) or an
# explicit (lo, hi) or None, mask kind or None, threshold, at_least)
FILTER_CASES = {
    "every-hash-kept": (100_003, None, (0, U64 - 1), "nibble", 15, False),
    "no-hash-kept": (100_003, None, (0, 0), None, 0, False),
    "band-edges": (65_536, None, "edges", None, 0, False),
    "band-of-four": (CHUNK, None, ("bands", 4, 1), None, 0, False),
    "nibble-mask-0": (CHUNK, None, None, "nibble", 0, False),
    "nibble-mask-0-masked": (CHUNK, None, None, "nibble", 0, True),
    "nibble-mask-15": (CHUNK, None, None, "nibble", 15, False),
    "nibble-mask-15-masked": (CHUNK, None, None, "nibble", 15, True),
    "bit-mask": (CHUNK, None, None, "bit", 0, False),
    "bit-mask-masked": (CHUNK, None, None, "bit", 1, True),
    "byte-mask-and-band": (CHUNK, None, ("bands", 4, 2), "byte", 2, False),
    "one-kept-at-the-end": (CHUNK, None, "last", None, 0, False),
    "padding-in-band": (CHUNK, 700_001, (0, U64 - 1), None, 0, False),
    "scan-rounds": (1 << 22, None, ("bands", 3, 0), "bit", 0, False),
    "one-hash": (1, None, (0, U64 - 1), None, 0, False),
}

# N's nibble bands: the plain presence, a band below the saturation, the
# band whose top is the saturation, one above it, an empty one and the
# saturated counts alone
NIBBLE_BANDS = ((1, 14), (1, 15), (2, 255), (0, 0), (15, 15), (1, 65535))

# name -> (k, primes near (or the primes), tables, nodes (the graph case:
# reads), fill)
NIBBLE_NBR_CASES = {
    "k1-T1": (1, (9001,), 1, 5000, "dense"),
    "k20-T4": (20, 1e6, 4, 100_003, "dense"),
    "k20-T4-sparse": (20, 1e6, 4, 100_003, "sparse"),
    "k32-T4": (32, 5e6, 4, 100_003, "dense"),
    "k20-odd-primes": (20, (7, 5, 3), 3, 1000, "dense"),
    "k31-odd-primes": (31, (11, 13, 17, 19), 4, 1000, "dense"),
    "k20-T4-all-15": (20, 1e5, 4, 20_000, "full"),
    "k20-T4-graph": (20, 2e6, 4, 2000, "graph"),
    "k20-one-node": (20, 1e5, 4, 1, "dense"),
    "k20-no-node": (20, 1e5, 4, 0, "dense"),
}
NIBBLE_NBR_CASES.update({
    "k20-T%d-n%d" % (t, n): (20, 1e5, t, n, "dense")
    for t in (1, 4, 7) for n in (1, 31, 33, 2048)})


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64)
                            .view(np.int64).copy())


def _primes(spec, ntables):
    if isinstance(spec, tuple):
        return spec
    return tuple(K.get_n_primes_near_x(ntables, int(spec)))


def _mask_counts(kind, hashes, rng):
    """The plain gather's counts (int32) of `hashes` (CPU) in seeded
    tables of the mask kind."""
    primes = tuple(K.get_n_primes_near_x(4, 200_003))
    if kind == "bit":
        flat = torch.from_numpy(rng.integers(
            0, 256, K.bit_flat_size(primes), dtype=np.uint8)
            & rng.integers(0, 256, K.bit_flat_size(primes), dtype=np.uint8))
        return K.bit_gather_plain(primes, flat, hashes)
    if kind == "byte":
        flat = torch.from_numpy(rng.integers(
            0, 5, K.byte_flat_size(primes), dtype=np.uint8))
        return K.byte_gather_plain(primes, flat, hashes)
    flat = torch.from_numpy(np.where(
        rng.random(K.nibble_flat_size(primes)) < 0.3, 0xFF,
        rng.integers(0, 256, K.nibble_flat_size(primes))).astype(np.uint8))
    return K.nibble_gather_plain(primes, flat, hashes)


def filter_inputs(name, seed=0):
    """(hashes, nvalid, band, counts or None, threshold, at_least) of S's
    case `name`, on the CPU."""
    n, nvalid, band, mask, threshold, at_least = FILTER_CASES[name]
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    h = rng.integers(0, U64, n, dtype=np.uint64)
    if band == "edges":
        lo, hi = compute_band_interval(5, 2)
        edges = np.array([lo - 1, lo, hi - 1, hi], np.uint64)
        h[rng.integers(0, n, n // 4)] = edges[rng.integers(0, 4, n // 4)]
        band = (lo, hi)
    elif band == "last":
        band = (U64 - 2**40, U64 - 1)
        h %= np.uint64(U64 - 2**40)
        h[-1] = np.uint64(U64 - 2)
    elif band is not None and band[0] == "bands":
        band = compute_band_interval(band[1], band[2])
    hashes = _t(h)
    counts = None if mask is None else _mask_counts(mask, hashes, rng)
    return hashes, n if nvalid is None else nvalid, band, counts, \
        threshold, at_least


def check_filter_case(name, dev):
    """S against consume_filter_plain on case `name`: the count's
    difference plus the kept hashes that differ (0 when equal)."""
    hashes, nvalid, band, counts, threshold, at_least = filter_inputs(name)
    want, want_n = K.consume_filter_plain(hashes, nvalid, band, counts,
                                          threshold, at_least)
    got, got_n = K.consume_filter_cuda(
        hashes.to(dev), nvalid, band,
        None if counts is None else counts.to(dev), threshold, at_least)
    m = int(want_n[0])
    err = abs(int(got_n[0]) - m)
    if err == 0:
        err = int((got[:m].cpu() != want[:m]).sum())
    return err


def _count_reads(flat, primes, canon):
    """Add each canonical value once to its 4-bit counter in every table
    of the joined nibble buffer `flat` (numpy u8, in place, saturating at
    15)."""
    for p, off in zip(primes, K.nibble_offsets(primes)):
        idx = (canon % np.uint64(p)).astype(np.int64) + 2 * off
        c = np.bincount(idx, minlength=2 * flat.shape[0])
        hi, lo = flat >> 4, flat & 0xF
        hi = np.minimum(hi.astype(np.int64) + c[0::2], 15)
        lo = np.minimum(lo.astype(np.int64) + c[1::2], 15)
        flat[:] = ((hi << 4) | lo).astype(np.uint8)


def nibble_nbr_inputs(name, dev, seed=0):
    """(primes, k, flat nibble buffer, f, r) of N-nibble's case `name` on
    `dev`."""
    from khmer_tpu_torch.core.partition import revcomp_bits
    from khmer_tpu_torch.scripts.partition_cases import read_kmers

    k, spec, ntables, n, fill = NIBBLE_NBR_CASES[name]
    primes = _primes(spec, ntables)
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    size = K.nibble_flat_size(primes)
    if fill == "sparse":  # about 0.4% of the bytes set
        flat = np.where(rng.random(size) < 0.004,
                        rng.integers(1, 256, size), 0).astype(np.uint8)
    elif fill == "dense":  # 60% of the bytes set
        flat = np.where(rng.random(size) < 0.6,
                        rng.integers(1, 256, size), 0).astype(np.uint8)
    elif fill == "full":
        flat = np.full(size, 0xFF, np.uint8)
    else:
        flat = np.zeros(size, np.uint8)
    if fill == "graph":
        f = read_kmers(rng, k, n)
        canon = np.minimum(f, revcomp_bits(f, k))
        for rep in range(3):
            _count_reads(flat, primes, canon[rng.random(len(canon))
                                             < 0.5 ** rep])
    else:
        f = rng.integers(0, 2**64, n, dtype=np.uint64)
        if k < 32:
            f &= np.uint64((1 << (2 * k)) - 1)
        else:
            f |= np.uint64(1 << 63)
    r = revcomp_bits(f, k)
    tables = torch.empty(size, dtype=torch.uint8, device=dev)
    tables.copy_(torch.from_numpy(flat))
    return primes, k, tables, _t(f).to(dev), _t(r).to(dev)


def check_nibble_nbr_case(name, dev):
    """N's nibble mode against nibble_neighbors_plain on case `name`, in
    both modes, without a band and at every band: the differing bytes."""
    primes, k, flat, f, r = nibble_nbr_inputs(name, dev)
    err = 0
    for band in (None,) + NIBBLE_BANDS:
        want = K.nibble_neighbors_plain(primes, flat, f, r, k, band)
        for small in (False, True):
            got = K.nibble_neighbors_cuda(primes, flat, f, r, k, band, small)
            pairs = zip(got, want) if band is not None else [(got, want)]
            err += sum(int((a != b).sum()) for a, b in pairs)
    return err


def main():
    dev = torch.device("cuda", 0)
    failed = 0
    for kind, cases, check in (("S", FILTER_CASES, check_filter_case),
                               ("N nibble", NIBBLE_NBR_CASES,
                                check_nibble_nbr_case)):
        for name in cases:
            err = check(name, dev)
            failed += err
            print(json.dumps({"kernel": kind, "case": name, "err": err}),
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
