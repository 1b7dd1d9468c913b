#!/usr/bin/env python
"""Kernel B (csrc/byte_gather.cu) on uniformly random live hashes, on the
card.

The byte gather serves get() and the abundance histogram; chip_smoke.py
times it on a real abundance batch, where about 70% of the slots are the
zero padding of a deduplicated batch. This script times it where every
hash is live and random: 2^20 and 2^22 hashes on the config-1 tables (4
primes near 5e7, 200 MB, random contents from a seed), kernel against its
plain version, with the two floors of a random gather beside it:

  * the byte bound: each hash read once (8 B), each count written once
    (4 B), each distinct counter read once (1 B), at 3.35 TB/s;
  * the sector floor: each distinct 32-byte sector of the counters read
    once, since the card reads device memory in sectors.

Needs a CUDA card. Run from the repo root:

    python -m khmer_tpu_torch.scripts.byte_gather_bench
"""

import json

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops.u64 import umod
from khmer_tpu_torch.scripts import cuda_ms

# the byte tables' primes: config 1 (-x 5e7 -N 4), -x 1e9 -N 4, -x 5e9 -N 4
PRIME_SETS = {
    "config-1": (49999991, 49999921, 49999903, 49999897),
    "-x 1e9 -N 4": (999999937, 999999929, 999999893, 999999883),
    "-x 5e9 -N 4": (4999999937, 4999999903, 4999999883, 4999999867),
}
CONFIG1_PRIMES = PRIME_SETS["config-1"]
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3


def reduction_edges(primes, n_random=5001, seed=0):
    """u64 hashes at the edges of the byte kernels' reduction by a
    reciprocal (csrc/u64_common.cuh reduce), for each prime p: 0, 1,
    2^63 - 1, 2^63, 2^64 - 1, p - 1, p, p + 1, and k p - 1, k p, k p + 1
    for the four largest multiples k p below 2^64, where umulhi(h, m)
    falls one short of floor(h / p); then n_random random ones."""
    vals = [0, 1, 2**63 - 1, 2**63, 2**64 - 1]
    for p in primes:
        top = (2**64 - 1) // p
        vals += [p - 1, p, p + 1]
        vals += [k * p + d for k in range(top - 3, top + 1)
                 for d in (-1, 0, 1)]
    vals = [v for v in vals if 0 <= v < 2**64]
    rng = np.random.default_rng(seed)
    return np.concatenate([np.asarray(vals, dtype=np.uint64),
                           rng.integers(0, 2**64, n_random,
                                        dtype=np.uint64)])


def gather_floors(primes, hashes):
    """(least bytes, distinct 32-byte sectors) of gathering `hashes` from
    the byte tables of `primes`: 12 B a hash plus each distinct counter
    once, and the distinct sectors (flat index >> 5) over all tables."""
    idx = torch.cat([umod(hashes, p) + off
                     for p, off in zip(primes, K.byte_offsets(primes))])
    counters = int(torch.unique(idx).numel())
    sectors = int(torch.unique(idx >> 5).numel())
    return 12 * hashes.shape[0] + counters, sectors


def time_gather(primes, flat, hashes, reps=50):
    """Kernel B and its plain version on `hashes`, checked equal; ms per
    call of each, and the two floors in ms."""
    got = K.byte_gather_cuda(primes, flat, hashes)
    err = int((got - K.byte_gather_plain(primes, flat, hashes)).abs().max())
    nbytes, sectors = gather_floors(primes, hashes)
    return {
        "hashes": hashes.shape[0], "max_abs_err": err,
        "ms": cuda_ms(lambda: K.byte_gather_cuda(primes, flat, hashes),
                      reps),
        "plain_ms": cuda_ms(lambda: K.byte_gather_plain(primes, flat,
                                                         hashes), reps),
        "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_S * 1e3,
        "sectors": sectors,
        "sector_floor_ms": sectors * 32 / PEAK_BYTES_S * 1e3,
    }


def main(primes=CONFIG1_PRIMES, sizes=(1 << 20, 1 << 22), reps=50, seed=0):
    """Time kernel B on len(sizes) batches of random hashes; returns the
    card's name, the primes and one time_gather result per batch."""
    if not torch.cuda.is_available():
        raise RuntimeError("byte_gather_bench needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randint(0, 256, (K.byte_flat_size(primes),),
                         dtype=torch.uint8, device=dev, generator=gen)
    rng = np.random.default_rng(seed)
    runs = []
    for n in sizes:
        hashes = torch.from_numpy(rng.integers(0, 2**64, n, dtype=np.uint64)
                                  .view(np.int64)).to(dev)
        runs.append(time_gather(primes, flat, hashes, reps))
    return {"device": torch.cuda.get_device_name(dev),
            "primes": list(primes), "runs": runs}


if __name__ == "__main__":
    print(json.dumps(main()))
