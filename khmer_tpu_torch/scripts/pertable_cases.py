"""Kernel M (csrc/byte_gather.cu khmer_byte_pertable) against its plain
version (core/sketch_kernels.py byte_pertable_plain) on adversarial
cases, on the card: no hash, one hash and 2^20 + 3; hashes at the edges
of the reduction by a reciprocal and near 2^64; one table, three, eight
and thirty-two; counters at 254 and 255; tables of more than 2^31 bytes;
n one below, at and one above a block's hashes (and the 2,048 of a block
of 8 hashes a thread); hash views at odd element offsets (not 16-byte
aligned); and n over several chunks of 2^21 hashes. chip_smoke.py phase 3
and tests/test_torch_gpu_kernels.py run them.

    python -m khmer_tpu_torch.scripts.pertable_cases
"""

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.scripts.byte_gather_bench import reduction_edges

# kernel M's threads a block, a hash each (csrc/byte_gather.cu
# kPerTableBlock)
BLOCK = 256

# name -> (tables, each prime near, hashes, how many, the hash view's
# first element in the tensor it is cut from)
PERTABLE_CASES = {
    "no-hash": (4, 1e5, "random", 0, 0),
    "one-hash": (4, 1e5, "random", 1, 0),
    "2^20+3": (4, 1e5, "edges", (1 << 20) + 3, 0),
    "near-2^64": (4, 1e6, "top", 1 << 14, 0),
    "one-table": (1, 1e6, "edges", 100_003, 0),
    "three-tables": (3, 1e5, "edges", 100_003, 0),
    "eight-tables": (8, 1e5, "edges", 100_003, 0),
    "thirty-two-tables": (32, 1e4, "edges", 100_003, 0),
    "saturated": (4, 1e5, "saturated", 100_003, 0),
    "over-2^31-bytes": (2, 1.2e9, "edges", 1 << 20, 0),
    "block-1": (4, 1e5, "random", BLOCK - 1, 0),
    "block": (4, 1e5, "random", BLOCK, 0),
    "block+1": (4, 1e5, "random", BLOCK + 1, 0),
    "2047": (4, 1e5, "random", 2047, 0),
    "2049": (3, 1e5, "random", 2049, 0),
    "odd-offset": (4, 1e5, "edges", 100_003, 1),
    "odd-offset-block+1": (3, 1e5, "random", BLOCK + 1, 3),
    "chunks": (4, 1e6, "random", 5_000_003, 0),
}


def case_inputs(name, dev):
    """(primes, the joined tables, the hashes as an int64 tensor) of a
    case, on `dev`, from seeds."""
    ntables, x, kind, n, offset = PERTABLE_CASES[name]
    primes = tuple(K.get_n_primes_near_x(ntables, x))
    gen = torch.Generator(device=dev).manual_seed(len(name))
    flat = torch.randint(0, 256, (K.byte_flat_size(primes),),
                         dtype=torch.uint8, device=dev, generator=gen)
    rng = np.random.default_rng(len(name))
    if kind == "top":
        h = np.concatenate([
            np.uint64(2**64 - 1) - np.arange(n // 2, dtype=np.uint64),
            np.uint64(2**63) + np.arange(n // 2, dtype=np.uint64)])
    elif kind == "edges":
        edges = reduction_edges(primes, 0)
        h = np.concatenate([edges, rng.integers(
            0, 2**64, n - len(edges), dtype=np.uint64)])
    else:
        h = rng.integers(0, 2**64, n, dtype=np.uint64)
    if kind == "saturated":
        flat.fill_(255)
        flat[torch.randint(0, flat.shape[0], (flat.shape[0] // 3,),
                           device=dev, generator=gen)] = 254
    whole = np.concatenate([rng.integers(0, 2**64, offset, np.uint64), h])
    hashes = torch.from_numpy(whole.view(np.int64)).to(dev)[offset:]
    return primes, flat, hashes


def check_pertable_case(name, dev):
    """The largest difference between kernel M and its plain version on
    a case (0 when they agree); raises if the shapes differ."""
    primes, flat, hashes = case_inputs(name, dev)
    got = K.byte_pertable_cuda(primes, flat, hashes)
    want = K.byte_pertable_plain(primes, flat, hashes)
    if got.shape != want.shape or got.dtype != torch.uint8:
        raise AssertionError("%s: kernel M gave %s %s, plain %s" % (
            name, got.dtype, tuple(got.shape), tuple(want.shape)))
    if got.numel() == 0:
        return 0
    return int((got.int() - want.int()).abs().max())


def main():
    dev = torch.device("cuda", 0)
    for name in PERTABLE_CASES:
        print(name, check_pertable_case(name, dev))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
