"""The port's murmur hashing (khmer_tpu_torch.ops.hashing) against the JAX
package's: the scalar hashes, the host window hash and the batched
window hash, bit for bit (tolerance 0), on seeded codes and palindromes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu.ops import hashing as J
from khmer_tpu_torch.ops import hashing as H

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

KS = [1, 4, 8, 16, 17, 20, 31, 32]


def _codes(seed, n):
    return np.random.default_rng(seed).integers(0, 4, n, dtype=np.uint8)


def _decode(codes):
    """2-bit codes -> DNA string."""
    return np.frombuffer(b"ATCG", np.uint8)[codes].tobytes().decode()


def _palindrome(seed, k):
    """A k-mer equal to its reverse complement (k even), as codes."""
    half = _codes(seed, k // 2)
    return np.concatenate([half, (half ^ 1)[::-1]]).astype(np.uint8)


def _u(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("k", KS)
def test_scalar_murmur_matches_jax(k):
    rng = np.random.default_rng(k)
    kmers = [_decode(_codes(int(s), k))
             for s in rng.integers(0, 2**31, 50)]
    kmers += ["".join(rng.choice(list("ACGTNacgtn"), k)) for _ in range(20)]
    if k % 2 == 0:
        kmers.append(_decode(_palindrome(k, k)))
    for kmer in kmers:
        assert H._hash_murmur_scalar(kmer) == J._hash_murmur_scalar(kmer)
        assert H.hash_murmur3(kmer) == J.hash_murmur3(kmer)
        assert H.hash_no_rc_murmur3(kmer) == J.hash_no_rc_murmur3(kmer)
        assert H.reverse_complement(kmer) == J.reverse_complement(kmer)
    if k % 2 == 0:
        p = _decode(_palindrome(k, k))
        assert H.reverse_complement(p) == p
        assert H.hash_murmur3(p) == H.hash_no_rc_murmur3(p)


@pytest.mark.parametrize("k", KS)
def test_window_murmur_matches_jax(k):
    """Batched windows of seeded rows with palindromes planted in them:
    canonical, h and r of every window against JAX's murmur_hash_windows,
    the host version against JAX's host version, and each window against
    the scalar hash."""
    codes = np.stack([_codes(100 + k + b, 96) for b in range(3)])
    if k % 2 == 0:
        for b in range(3):
            codes[b, 7 * b:7 * b + k] = _palindrome(b, k)
    got = H.murmur_hash_windows(torch.from_numpy(codes), k)
    want = J.murmur_hash_windows(jnp.asarray(codes), k)
    for g, w in zip(got, want):
        assert np.array_equal(_u(g), np.asarray(w))
    canon = _u(got[0])
    for b in range(3):
        host = H.host_murmur_hash_windows(codes[b], k)
        assert np.array_equal(host, canon[b])
        assert np.array_equal(host, J.host_murmur_hash_windows(codes[b], k))
        for i in range(0, canon.shape[1], 11):
            kmer = _decode(codes[b, i:i + k])
            assert canon[b, i] == H.hash_murmur3(kmer)
    if k % 2 == 0:
        # the planted palindromes canonicalize to h
        h = _u(got[1])
        for b in range(3):
            assert canon[b, 7 * b] == h[b, 7 * b]


@pytest.mark.parametrize("k", [33, 40, 64, 65, 70])
def test_window_murmur_beyond_32_follows_the_jax_device_rule(k):
    """For k > 32 JAX tests a palindrome on the 64-bit 2-bit words, which
    keep a window's last 32 codes: for k <= 64 that is the true test, for
    k > 64 also a window whose last 32 codes mirror its first 32 is taken
    for one (JAX's native host hash, its `auto` engine, tests the whole
    window). The port follows murmur_hash_windows."""
    rng = np.random.default_rng(k)
    row = rng.integers(0, 4, 3 * k, dtype=np.uint8)
    half = rng.integers(0, 4, 32, dtype=np.uint8)
    row[:32] = half                      # a window at 0 whose last 32
    row[k - 32:k] = (half ^ 1)[::-1]     # codes mirror its first 32
    if k % 2 == 0 and k <= 64:
        row[k:2 * k] = _palindrome(k, k)
    got = H.murmur_hash_windows(torch.from_numpy(row), k)
    want = J.murmur_hash_windows(jnp.asarray(row), k)
    for g, w in zip(got, want):
        assert np.array_equal(_u(g), np.asarray(w))
    canon, h = _u(got[0]), _u(got[1])
    window0 = _decode(row[:k])
    if k > 64:
        # taken for a palindrome, though it is not one
        assert H.reverse_complement(window0) != window0
        assert canon[0] == h[0] != H.hash_murmur3(window0)
    else:
        assert canon[0] == H.hash_murmur3(window0)
        if k % 2 == 0:
            assert canon[k] == h[k] == H.hash_murmur3(_decode(
                row[k:2 * k]))


def test_hash_windows_serves_murmur():
    codes = torch.from_numpy(_codes(5, 64))
    assert torch.equal(H.hash_windows(codes, 20, "murmur"),
                       H.murmur_hash_windows(codes, 20)[0])
    with pytest.raises(ValueError):
        H.hash_windows(codes, 20, "nope")


@pytest.mark.parametrize("k", [4, 20, 32])
def test_scalar_twobit_helpers_match_jax(k):
    rng = np.random.default_rng(k)
    for s in rng.integers(0, 2**31, 20):
        kmer = _decode(_codes(int(s), k))
        canon, f, r = H._hash_scalar(kmer, k)
        assert canon == J.forward_hash(kmer, k)
        assert f == J.forward_hash_no_rc(kmer, k)
        assert H.reverse_hash(f, k) == J.reverse_hash(f, k) == kmer
    with pytest.raises(ValueError):
        H._hash_scalar("A" * (k - 1), k)
