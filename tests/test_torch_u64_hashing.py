"""khmer_tpu_torch.ops.u64 and ops.hashing against numpy uint64 and the
JAX package. Hashes are compared bit for bit (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu.core import blocked as jax_blocked
from khmer_tpu.ops import hashing as jax_hashing
from khmer_tpu_torch.ops import hashing as H
from khmer_tpu_torch.ops import u64
from khmer_tpu_torch.scripts.byte_gather_bench import (PRIME_SETS,
                                                       reduction_edges)

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

EDGES = np.array([0, 1, 2, 3, 2**31 - 1, 2**32, 2**62, 2**63 - 1, 2**63,
                  2**63 + 1, 2**64 - 2, 2**64 - 1], dtype=np.uint64)


def _values(seed=0, n=4000):
    rng = np.random.default_rng(seed)
    full = rng.integers(0, 2**64, n, dtype=np.uint64)
    high = full | np.uint64(1 << 63)
    return np.concatenate([EDGES, full, high])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64)
                            .view(np.int64).copy())


def _u(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("x", [0, 1, 2**63 - 1, 2**63, 2**64 - 1])
def test_to_signed_keeps_the_bits(x):
    assert np.int64(u64.to_signed(x)).view(np.uint64) == np.uint64(x)


@pytest.mark.parametrize("s", [0, 1, 5, 10, 15, 27, 30, 31, 33, 63])
def test_srl_matches_numpy(s):
    a = _values(s)
    assert (_u(u64.srl(_t(a), s)) == a >> np.uint64(s)).all()


@pytest.mark.parametrize("p", [
    1, 2, 7, 101, 100003, 1562471, 16777213,
    1562471 * 32,            # tracking-table size of config 1
    16777213 * 32, 2**61 - 1])
def test_umod_matches_numpy(p):
    a = _values(p % 1000)
    got = u64.umod(_t(a), p).numpy()
    assert got.dtype == np.int64
    assert (got == (a % np.uint64(p)).astype(np.int64)).all()


@pytest.mark.parametrize("name", list(PRIME_SETS))
def test_umod_reciprocal_matches_numpy(name):
    """The byte kernels' reduction by a precomputed reciprocal
    (csrc/u64_common.cuh reduce), mirrored step for step, equals numpy's
    uint64 % on every edge case of each table's prime."""
    primes = PRIME_SETS[name]
    a = reduction_edges(primes, 4000)
    for p in primes:
        got = u64.umod_reciprocal(_t(a), p).numpy()
        assert (got == (a % np.uint64(p)).astype(np.int64)).all()
        assert (got >= 0).all() and (got < p).all()


def test_prime_sets_are_the_tables_primes():
    from khmer_tpu_torch.core.sketch_kernels import get_n_primes_near_x

    for x, name in ((5e7, "config-1"), (1e9, "-x 1e9 -N 4"),
                    (5e9, "-x 5e9 -N 4")):
        assert tuple(get_n_primes_near_x(4, x)) == PRIME_SETS[name]


@pytest.mark.parametrize("m", [0, 1, 3, 2**32 - 1, 2**32, 2**63 + 5,
                               2**64 - 1, ((1 << 64) - 1) // 49999991])
def test_umulhi_matches_python_ints(m):
    a = _values(m % 997)
    want = np.asarray([(int(x) * m) >> 64 for x in a], dtype=np.uint64)
    assert (_u(u64.umulhi(_t(a), m)) == want).all()


@pytest.mark.parametrize("p", [1, 2, 7, 2**62 + 135, 2**63 - 25])
def test_umod_reciprocal_at_extreme_moduli(p):
    a = reduction_edges((p,), 4000)
    assert (_u(u64.umod_reciprocal(_t(a), p)) == a % np.uint64(p)).all()
    assert u64.reciprocal(p) == (2**64 - 1) // p


def test_ult_and_umin_match_numpy():
    a = _values(1)
    b = np.roll(_values(2), 7)
    assert (u64.ult(_t(a), _t(b)).numpy() == (a < b)).all()
    assert (_u(u64.umin(_t(a), _t(b))) == np.minimum(a, b)).all()


def test_mix64_matches_jax():
    a = _values(3)
    want = np.asarray(jax_blocked.mix64(jnp.asarray(a)))
    assert (_u(u64.mix64(_t(a))) == want).all()


@pytest.mark.parametrize("k", [4, 20, 31, 32])
def test_rolling_hash_windows_matches_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (3, 90), dtype=np.uint8)
    codes[0, :40] = 3   # all-G run: the hashes with the top bits set
    codes[1, :40] = 0   # all-A run: hash 0
    want = jax_hashing.rolling_hash_windows(jnp.asarray(codes), k)
    got = H.rolling_hash_windows(torch.from_numpy(codes), k)
    for w, g in zip(want, got):
        assert (_u(g) == np.asarray(w)).all()


@pytest.mark.parametrize("k", [4, 20, 32])
def test_host_hash_and_scalar_hash_match_jax(k):
    rng = np.random.default_rng(100 + k)
    seq = "".join("ACGTN"[i] for i in rng.integers(0, 5, 200))
    codes = H.encode_dna(seq)
    assert (codes == jax_hashing.encode_dna(seq)).all()
    assert (H.host_hash_windows(codes, k)
            == jax_hashing.host_hash_windows(codes, k)).all()
    kmer = seq[17:17 + k]
    assert H._hash_scalar(kmer, k) == jax_hashing._hash_scalar(kmer, k)
