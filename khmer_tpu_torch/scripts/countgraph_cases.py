"""Seeded cases that hold the Countgraph graph's kernels to their plain
versions, exactly: kernel N (csrc/neighbors.cu, byte_neighbors_cuda
against byte_neighbors_plain), kernel A's per-event new flags
(byte_update_cuda against byte_update_plain with with_event_new) and
kernel H's counts mode (read_window_counts_cuda against
read_window_counts_plain).

N's cases are byte tables and a batch of nodes: k 1, 20 and 32 (f >= 2^63
at 32), 1, 4 and 32 tables, tiny primes on which every neighbour
collides, a batch of one node, an empty one and 100,003 nodes (not a
whole number of blocks); counters 60% set (98% in 32 tables: presence
varies), 0.4% set (table 0 settles most lanes), at 250-255 under a bigcount table, all 255, and a graph of the k-mers of seeded
reads counted into the tables; and levels of 1, 31, 33 and 2,048 nodes
(a warp's edge, a block's) at 1, 4 and 7 tables (8, 32 lanes a node; two
tables a lane), 60% set, and 90% set, most at 255, under a bigcount
table.
Each is probed in both of N's modes (small-level and staged), without a
band and at every band of BANDS. A's cases are chunk sequences: hashes
sharing counters inside a chunk (tiny primes), a few hashes whose
counters saturate within a chunk, full-range hashes, and a full 2^20
chunk. H's cases are trim_cases.COUNT_CASES. On the card:

    python -m khmer_tpu_torch.scripts.countgraph_cases
"""

import json

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops.u64 import umin

# (lo, hi) bands of N: the plain presence, config 5's abundance band, a
# band that drops every count of 1, one that reaches into the bigcount map
# and one above 255 alone
BANDS = ((1, 255), (2, 200), (2, 255), (1, 65535), (300, 65535),
         (0, 0))

# name -> (k, primes near (or the primes), tables, nodes (the graph case:
# reads), fill)
NBR_CASES = {
    "k1-T1": (1, (9001,), 1, 5000, "dense"),
    "k20-T4": (20, 1e6, 4, 100003, "dense"),
    "k20-T4-sparse": (20, 1e6, 4, 100003, "sparse"),
    "k32-T4-high": (32, 5e6, 4, 100003, "dense"),
    "k20-T32": (20, 3e4, 32, 20000, "near-full"),
    "k20-tiny-primes": (20, (7, 5, 3, 2), 4, 1000, "dense"),
    "k20-one-node": (20, 1e5, 4, 1, "dense"),
    "k20-no-node": (20, 1e5, 4, 0, "dense"),
    "k20-T4-saturated": (20, 1e5, 4, 20000, "saturated"),
    "k20-T4-all-255": (20, 1e5, 4, 20000, "full"),
    "k20-T4-graph": (20, 2e6, 4, 2000, "graph"),
}
# the levels of a walk that N's two modes split, both held to plain
NBR_CASES.update({
    "k20-T%d-n%d-%s" % (t, n, fill): (20, 1e5, t, n, fill)
    for t in (1, 4, 7) for n in (1, 31, 33, 2048) for fill in ("dense",
                                                              "high")})

# name -> (primes, chunks, events a chunk, distinct hashes)
FLAG_CASES = {
    "shared counters": ((7, 5, 3, 2), 3, 4096, 1 << 30),
    "saturating bins": ((100003, 100019, 100043, 100049), 3, 65536, 37),
    "full range": ((1000003, 1000033, 1000037, 1000039), 4, 65536, 1 << 40),
    "2^20 chunk": ((4000037, 4000039, 4000081, 4000111), 2, 1 << 20,
                   1 << 18),
}


def _primes(spec, ntables):
    if isinstance(spec, tuple):
        return spec
    return tuple(K.get_n_primes_near_x(ntables, int(spec)))


def _count_reads(flat, primes, canon):
    """Add each canonical value once to its counter in every table of the
    joined byte buffer `flat` (numpy u8, in place, saturating at 255)."""
    for p, off in zip(primes, K.byte_offsets(primes)):
        idx = (canon % np.uint64(p)).astype(np.int64) + off
        c = np.bincount(idx, minlength=flat.shape[0])
        flat[:] = np.minimum(flat.astype(np.int64) + c, 255).astype(np.uint8)


def nbr_inputs(name, dev, seed=0):
    """(primes, k, flat byte buffer, f, r, bigcount table or None) of case
    `name` on `dev`."""
    from khmer_tpu_torch.core.partition import revcomp_bits
    from khmer_tpu_torch.scripts.partition_cases import read_kmers

    k, spec, ntables, n, fill = NBR_CASES[name]
    primes = _primes(spec, ntables)
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    size = K.byte_flat_size(primes)
    if fill == "sparse":  # about 0.4% of counters set, counts 1-9
        flat = np.where(rng.random(size) < 0.004,
                        rng.integers(1, 10, size), 0).astype(np.uint8)
    elif fill in ("dense", "near-full"):  # 60% or 98% of counters set
        flat = np.where(rng.random(size) < (0.6 if fill == "dense" else 0.98),
                        rng.integers(1, 256, size), 0).astype(np.uint8)
    elif fill == "saturated":
        flat = np.where(rng.random(size) < 0.5,
                        rng.integers(250, 256, size), 0).astype(np.uint8)
    elif fill == "high":  # 85% at 255, 10% 0, the rest 1-254
        u = rng.random(size)
        flat = np.where(u < 0.85, 255, np.where(
            u < 0.95, 0, rng.integers(1, 255, size))).astype(np.uint8)
    elif fill == "full":
        flat = np.full(size, 255, np.uint8)
    else:  # the graph of seeded reads, each k-mer counted 1 to 3 times
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
    big = None
    if fill in ("saturated", "high", "full", "graph"):
        # a bigcount entry for a third of the saturated neighbours
        nf, nr = K.neighbor_kmers(_t(f), _t(r), k)
        canon = umin(nf, nr)
        sat = canon[K.byte_gather_plain(primes, torch.from_numpy(flat),
                                        canon) == 255]
        keys = np.unique(sat.numpy().view(np.uint64))[::3]
        values = rng.integers(256, 1000, len(keys))
        big = K.bigcount_table(dict(zip(keys.tolist(), values.tolist())),
                               dev)
    return (primes, k, torch.from_numpy(flat).to(dev), _t(f).to(dev),
            _t(r).to(dev), big)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64)
                            .view(np.int64).copy())


def check_nbr_case(name, dev):
    """N against byte_neighbors_plain on case `name`, in both modes,
    without a band and at every band: the differing bytes."""
    primes, k, flat, f, r, big = nbr_inputs(name, dev)
    err = 0
    for band in (None,) + BANDS:
        want = K.byte_neighbors_plain(primes, flat, f, r, k, band, big)
        for small in (False, True):
            got = K.byte_neighbors_cuda(primes, flat, f, r, k, band, big,
                                        small)
            pairs = zip(got, want) if band is not None else [(got, want)]
            err += sum(int((a != b).sum()) for a, b in pairs)
    return err


def flag_chunks(name, seed=0):
    """(primes, [(hashes u64 [m], nvalid)]) of A's case `name`."""
    primes, n_chunks, m, pool = FLAG_CASES[name]
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    values = rng.integers(0, 2**64, min(pool, 4 * m), dtype=np.uint64)
    chunks = []
    for c in range(n_chunks):
        h = values[rng.integers(0, len(values), m)]
        nvalid = m - 97 * c
        h[nvalid:] = 0
        chunks.append((h, nvalid))
    return primes, chunks


def check_flag_case(name, dev):
    """A with its new flags against byte_update_plain on case `name`, a
    chunk after another from empty tables with bigcount on: the differing
    flags, counters, unique counts and bigcount triggers."""
    primes, chunks = flag_chunks(name)
    flat_k = torch.zeros(K.byte_flat_size(primes), dtype=torch.uint8,
                         device=dev)
    flat_p = flat_k.clone()
    nu_k = torch.zeros(1, dtype=torch.int64, device=dev)
    nu_p = nu_k.clone()
    err = 0
    for h, nvalid in chunks:
        hd = _t(h).to(dev)
        rk, fk = K.byte_update_cuda(primes, flat_k, nu_k, hd, nvalid, True,
                                    with_event_new=True)
        rp, fp = K.byte_update_plain(primes, flat_p, nu_p, hd, nvalid, True,
                                     with_event_new=True)
        err += int((fk != fp).sum()) + int((flat_k != flat_p).sum())
        err += abs(int(nu_k) - int(nu_p))
        err += int(_triggers(rk) != _triggers(rp))
    return err


def _triggers(report):
    n = int(report[2][0])
    return K.bigcount_triggers(report[0][:n].cpu().numpy().view(np.uint64),
                               report[1][:n].cpu().numpy())


def check_counts_case(name, dev):
    """H's counts mode against read_window_counts_plain on
    trim_cases.COUNT_CASES[name]: the differing counters."""
    from khmer_tpu_torch.scripts.trim_cases import make_count_case

    primes, k, codes, lengths, fill, _, _ = make_count_case(name)
    c = torch.from_numpy(codes).to(dev)
    n = torch.from_numpy(lengths).to(dev)
    flat = torch.from_numpy(fill).to(dev)
    got = K.read_window_counts_cuda(primes, k, flat, c, n)
    want = K.read_window_counts_plain(primes, k, flat, c, n)
    return int((got != want).sum())


def byte_probe_floors(primes, flat, f, r, k):
    """The sector floors of kernel N on nodes (f, r) (tensors on the
    tables' device): (the distinct 32-byte sectors of every table's counter
    of every neighbour, those of the counters N's rule loads, a lane going
    on while its least counter is above 0: table 0 for every lane, then
    csrc kGroup = 4 tables a stage), and the counter loads of that
    rule."""
    from khmer_tpu_torch.ops.u64 import umod

    nf, nr = K.neighbor_kmers(f, r, k)
    canon = umin(nf, nr).reshape(-1)
    alive = torch.ones_like(canon, dtype=torch.bool)
    least = torch.full_like(canon, 255)
    every, loaded, loads = [], [], 0
    offsets = K.byte_offsets(primes)
    for t0 in [0] + list(range(1, len(primes), 4)):
        group = range(t0, 1) if t0 == 0 else range(t0, min(t0 + 4,
                                                            len(primes)))
        go = alive.clone()
        for t in group:
            idx = umod(canon, primes[t]) + offsets[t]
            every.append(idx >> 5)
            loaded.append((idx >> 5)[go])
            loads += int(go.sum())
            least = torch.where(go, torch.minimum(
                least, flat[idx].to(torch.int64)), least)
        alive = go & (least > 0)
    distinct = lambda parts: int(torch.unique(torch.cat(parts)).numel())
    return distinct(every), distinct(loaded), loads


def main():
    from khmer_tpu_torch.scripts.trim_cases import COUNT_CASES

    dev = torch.device("cuda", 0)
    failed = 0
    for kind, cases, check in (("N", NBR_CASES, check_nbr_case),
                               ("A flags", FLAG_CASES, check_flag_case),
                               ("H counts", COUNT_CASES, check_counts_case)):
        for name in cases:
            err = check(name, dev)
            failed += err
            print(json.dumps({"kernel": kind, "case": name, "err": err}),
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
