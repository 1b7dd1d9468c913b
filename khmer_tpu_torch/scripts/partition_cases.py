"""Seeded cases that hold kernel L (csrc/neighbors.cu) to its plain
versions: the 8-neighbour probe (neighbors_cuda against neighbors_plain)
and the bit gather (bit_gather_cuda against bit_gather_plain), exactly;
and probe_stages, the kernel's loading rule mirrored in plain PyTorch,
with the sector floors of a probe.

Each case is a set of bit tables and a batch of nodes or hashes: k 1, 15,
20, 31 and 32 (f >= 2^63 at 32), 1, 4 and 32 tables, the one-bit table
of Nodegraph(k, 1, 1), tiny primes on which every neighbour collides, a
batch of one node, an empty one, and 100,003 nodes (not a whole number
of blocks). The tables are about 40% set (88% where few bits or many
tables would leave no neighbour present); the fill cases are about 0.4%
set (as sparse as a graph of 4 GB: stage 0 settles most neighbours),
empty (no survivor after stage 0), all set (every neighbour loads every
table) and a graph: the k-mers of seeded reads loaded into tables about
0.3% set, probed from those k-mers, so that survivors are real
neighbours. On the card:

    python -m khmer_tpu_torch.scripts.partition_cases
"""

import numpy as np

# name -> (k, primes near (or the primes), nodes (the graph case: reads))
NEIGHBOR_CASES = {
    "k1-T1": (1, (9001,), 5000),
    "k15-T4": (15, 20000, 100003),
    "k20-T4": (20, 1e6, 100003),
    "k31-T4": (31, 77777, 4096),
    "k32-T4-high": (32, 5e6, 100003),
    "k20-T32": (20, 3e4, 20000),
    "k20-one-bit-table": (20, (1,), 1000),
    "k20-tiny-primes": (20, (7, 5, 3, 2), 1000),
    "k20-one-node": (20, 1e5, 1),
    "k20-no-node": (20, 1e5, 0),
    "k20-T4-sparse": (20, 1e6, 100003),
    "k20-T4-empty": (20, 1e6, 100003),
    "k20-T4-full": (20, 1e6, 100003),
    "k20-T4-graph": (20, 1.6e7, 1000),
}
_TABLES = {"k20-T32": 32, "k1-T1": 1}
# how a case's tables are filled (the others about 40% set): about 88%,
# so that neighbours are found in 32 tables and in one-bit tables; about
# 0.4%; empty; all set; the k-mers of reads
_FILL = {"k20-T32": "dense", "k20-one-bit-table": "dense",
         "k20-tiny-primes": "dense", "k20-T4-sparse": "sparse",
         "k20-T4-empty": "empty", "k20-T4-full": "full",
         "k20-T4-graph": "graph"}

# kernel L's rule (csrc/neighbors.cu kFirst, kGroup): stage 0 loads FIRST
# tables for every value, each later stage GROUP tables for the values
# still present, a byte load a value
FIRST, GROUP = 1, 4
SECTOR_BITS = 256  # a 32-byte sector


def _primes(K, name):
    _, primes, _ = NEIGHBOR_CASES[name]
    if isinstance(primes, tuple):
        return primes
    return tuple(K.get_n_primes_near_x(_TABLES.get(name, 4), int(primes)))


def read_kmers(rng, k, nreads, length=100, genome_len=20000, sub=0.01):
    """The forward k-mers (numpy u64, every window of every read) of
    `nreads` seeded reads of a random genome with substitutions."""
    genome = rng.integers(0, 4, genome_len)
    out = []
    for _ in range(nreads):
        s = int(rng.integers(0, genome_len - length))
        read = genome[s:s + length].copy()
        hit = rng.random(length) < sub
        read[hit] = rng.integers(0, 4, int(hit.sum()))
        f = np.zeros(length - k + 1, np.uint64)
        for j in range(k):
            f = (f << np.uint64(2)) | read[j:j + len(f)].astype(np.uint64)
        out.append(f)
    return np.concatenate(out)


def _load_bits(flat, primes, f, r):
    """Set the bits of the canonical values min(f, r) in every table of
    the joined buffer `flat` (numpy u8, in place)."""
    from khmer_tpu_torch.core import sketch_kernels as K

    canon = np.minimum(f, r)
    for p, off in zip(primes, K.bit_offsets(primes)):
        b = canon % np.uint64(p) + np.uint64(8 * off)
        np.bitwise_or.at(flat, (b >> np.uint64(3)).astype(np.int64),
                         (np.uint8(1) << (b & np.uint64(7)).astype(np.uint8)))


def case_inputs(name, dev, seed=0):
    """(primes, flat bit buffer, f, r, hashes) of a case on `dev`."""
    import torch

    from khmer_tpu_torch.core import sketch_kernels as K
    from khmer_tpu_torch.core.partition import revcomp_bits

    k, _, n = NEIGHBOR_CASES[name]
    primes = _primes(K, name)
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    size = K.bit_flat_size(primes)
    fill = _FILL.get(name)
    bits = [rng.integers(0, 256, size, dtype=np.uint8) for _ in range(8)]
    if fill == "dense":
        flat = bits[0] | bits[1] | bits[2]
    elif fill == "sparse":
        flat = np.bitwise_and.reduce(bits)
    elif fill in ("empty", "graph"):
        flat = np.zeros(size, np.uint8)
    elif fill == "full":
        flat = np.full(size, 255, np.uint8)
    else:
        flat = (bits[0] & bits[1]) | (bits[2] & bits[3] & bits[4])
    if fill == "graph":
        f = read_kmers(rng, k, n)
        _load_bits(flat, primes, f, revcomp_bits(f, k))
    else:
        f = rng.integers(0, 2**64, n, dtype=np.uint64)
    if k < 32:
        f &= np.uint64((1 << (2 * k)) - 1)
    else:
        f[::2] |= np.uint64(1 << 63)
    r = revcomp_bits(f, k)
    h = rng.integers(0, 2**64, 2 * len(f) + 5, dtype=np.uint64)
    if fill == "graph":  # half of them the nodes' own hashes
        h[:len(f)] = np.minimum(f, r)

    def t(a):
        return torch.from_numpy(a.view(np.int64).copy()).to(dev)

    return (primes, torch.from_numpy(flat).to(dev), t(f), t(r), t(h))


def _canon(f, r, k):
    from khmer_tpu_torch.core import sketch_kernels as K
    from khmer_tpu_torch.ops.u64 import umin

    nf, nr = K.neighbor_kmers(f, r, k)
    return umin(nf, nr)


def _flat_bits(primes, canon):
    """The flat bit index of each value of `canon` [N, V] in each table:
    a list of T int64 [N, V] tensors."""
    from khmer_tpu_torch.core import sketch_kernels as K
    from khmer_tpu_torch.ops.u64 import umod

    return [umod(canon, p) + 8 * off
            for p, off in zip(primes, K.bit_offsets(primes))]


def _bit_set(flat, b):
    import torch

    return ((flat[b >> 3].to(torch.int64) >> (b & 7)) & 1) == 1


def probe_stages(primes, flat, canon):
    """Kernel L's loading rule on the values `canon` (int64 [N, V] u64
    bit patterns; a node's V = 8 neighbours, or V = 1 for the gather), in
    plain PyTorch (any device): stage 0 loads tables [0, FIRST) for every
    value, each later stage the next GROUP tables for the values set in
    every table before it, a load a value and table. Returns (present,
    bool [N, V]; one dict a stage: "tables" (t0, t1), "rows" the rows
    that load in it, "loads", "sectors" the distinct 32-byte sectors they
    read)."""
    import torch

    live = torch.ones(canon.shape, dtype=torch.bool, device=canon.device)
    stages = []
    t0, ntables = 0, len(primes)
    bits = _flat_bits(primes, canon)
    width = FIRST
    while t0 < ntables:
        t1 = min(t0 + width, ntables)
        rows = live.any(1)
        loads, sectors = 0, []
        keep = live.clone()
        for b in bits[t0:t1]:
            loads += int(live.sum())
            sectors.append(b[live] // SECTOR_BITS)
            keep &= _bit_set(flat, b) | ~live
        stages.append({"tables": (t0, t1), "rows": int(rows.sum()),
                       "loads": loads,
                       "sectors": int(torch.unique(torch.cat(sectors))
                                      .numel())})
        live = keep
        t0, width = t1, GROUP
        if not bool(live.any()):
            break
    return live, stages


def neighbor_stages(primes, flat, f, r, k):
    """probe_stages on the neighbours of nodes (f, r): (the present-
    neighbour bytes, uint8 [N], as neighbors_plain gives them; the
    stages)."""
    import torch

    live, stages = probe_stages(primes, flat, _canon(f, r, k))
    shifts = torch.arange(8, dtype=torch.int64, device=f.device)
    return (live.to(torch.int64) << shifts).sum(1).to(torch.uint8), stages


def probe_floors(primes, flat, f, r, k):
    """The two sector floors of probing nodes (f, r): the distinct 32-byte
    sectors of every table's bit of every neighbour (what a probe that
    reads every table must read), and those a probe that stops at a
    neighbour's first unset bit must read in table order (table 0's
    sector for every neighbour, then table t's for each neighbour set in
    all tables before t)."""
    import torch

    canon = _canon(f, r, k)
    live = torch.ones(canon.shape, dtype=torch.bool, device=f.device)
    every, needed = [], []
    for b in _flat_bits(primes, canon):
        s = b // SECTOR_BITS
        every.append(s.reshape(-1))
        needed.append(s[live])
        live &= _bit_set(flat, b)
    return (int(torch.unique(torch.cat(every)).numel()),
            int(torch.unique(torch.cat(needed)).numel()))


def check_neighbor_case(name, dev):
    """Kernel L's probe and gather against their plain versions on case
    `name`: the number of bytes and flags that differ (0 when exact)."""
    import torch

    from khmer_tpu_torch.core import sketch_kernels as K

    k = NEIGHBOR_CASES[name][0]
    primes, flat, f, r, h = case_inputs(name, dev)
    got = K.neighbors_cuda(primes, flat, f, r, k)
    want = K.neighbors_plain(primes, flat, f, r, k)
    g_got = K.bit_gather_cuda(primes, flat, h)
    g_want = K.bit_gather_plain(primes, flat, h)
    torch.cuda.synchronize()
    return int((got != want).sum()) + int((g_got != g_want).sum())


def main():
    import sys

    import torch

    if not torch.cuda.is_available():
        print("partition_cases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    bad = {name: check_neighbor_case(name, dev) for name in NEIGHBOR_CASES}
    print(bad)
    return 1 if any(bad.values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
