"""Seeded cases that hold kernel L (csrc/neighbors.cu) to its plain
versions: the 8-neighbour probe (neighbors_cuda against neighbors_plain)
and the bit gather (bit_gather_cuda against bit_gather_plain), exactly.

Each case is a set of bit tables about 40% set (88% where few bits or
many tables would leave no neighbour present) and a batch of nodes or
hashes: k 1, 15, 20, 31 and 32 (f >= 2^63 at 32), 1, 4 and 32 tables,
the one-bit table of Nodegraph(k, 1, 1), tiny primes on which every
neighbour collides, a batch of one node, an empty one, and 100,003 nodes
(not a whole number of blocks). On the card:

    python -m khmer_tpu_torch.scripts.partition_cases
"""

import numpy as np

# name -> (k, primes near (or the primes), nodes)
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
}
_TABLES = {"k20-T32": 32, "k1-T1": 1}
# cases whose tables are about 88% set (the others about 40%), so that
# neighbours are found in 32 tables and in one-bit tables
_DENSE = ("k20-T32", "k20-one-bit-table", "k20-tiny-primes")


def _primes(K, name):
    _, primes, _ = NEIGHBOR_CASES[name]
    if isinstance(primes, tuple):
        return primes
    return tuple(K.get_n_primes_near_x(_TABLES.get(name, 4), int(primes)))


def case_inputs(name, dev, seed=0):
    """(primes, flat bit buffer, f, r, hashes) of a case on `dev`."""
    import torch

    from khmer_tpu_torch.core import sketch_kernels as K
    from khmer_tpu_torch.core.partition import revcomp_bits

    k, _, n = NEIGHBOR_CASES[name]
    primes = _primes(K, name)
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    size = K.bit_flat_size(primes)
    bits = [rng.integers(0, 256, size, dtype=np.uint8) for _ in range(5)]
    if name in _DENSE:
        flat = bits[0] | bits[1] | bits[2]
    else:
        flat = (bits[0] & bits[1]) | (bits[2] & bits[3] & bits[4])
    f = rng.integers(0, 2**64, n, dtype=np.uint64)
    if k < 32:
        f &= np.uint64((1 << (2 * k)) - 1)
    else:
        f[::2] |= np.uint64(1 << 63)
    r = revcomp_bits(f, k)
    h = rng.integers(0, 2**64, 2 * n + 5, dtype=np.uint64)

    def t(a):
        return torch.from_numpy(a.view(np.int64).copy()).to(dev)

    return (primes, torch.from_numpy(flat).to(dev), t(f), t(r), t(h))


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
