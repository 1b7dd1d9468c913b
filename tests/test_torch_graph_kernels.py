"""The rules of kernels J and K as their CUDA sources apply them, mirrored
in Python and held to the JAX package on the CPU: K's murmur words built
from 4-code groups of sliding 2-bit words by a byte permutation, its
palindrome test on those words and its window validity from the last read
start a thread's run has passed (csrc/hll_add.cu); J's split into a probe
that settles the lanes on bits already set and a commit of the open lanes
alone (csrc/bit_update.cu, sketch_kernels.bit_probe_plain and
bit_commit_plain)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu.core import pipeline as jax_pipeline
from khmer_tpu.ops import hashing as JH
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.scripts import graph_cases

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

# csrc/hll_add.cu kAsciiComp: byte c is the ASCII of code c ^ 1
ASCII_COMP = 0x43474154
M64 = (1 << 64) - 1


def byte_perm(x, y, s):
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the 8 bytes y:x (the selectors' sign-replicate bit unused here)."""
    both = (y << 32) | x
    return sum(((both >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def ascii_word(w, k, m):
    """hll_add.cu ascii_word: bytes [8m, 8m + 8) of a strand of k <= 32
    bytes from w = sum c_t << 2t, byte t the ASCII of code c_t ^ 1."""
    x = (w >> (16 * m)) & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    word = byte_perm(ASCII_COMP, 0, x >> 16) << 32 | byte_perm(
        ASCII_COMP, 0, x & 0xFFFF)
    n = k - 8 * m
    return word if n >= 8 else word & ((1 << (8 * n)) - 1)


def slide(tile, nw, k):
    """hll_add.cu slide_run over a staged tile (codes, start marks) in
    runs of HLL_RUN windows: {window: (valid, f2, r2)}."""
    k32 = min(k, 32)
    mask = M64 >> (64 - 2 * k32)
    top = 2 * (k32 - 1)
    out = {}
    for i0 in range(0, nw, K.HLL_RUN):
        f2 = r2 = 0
        last = -1
        for q in range(i0, i0 + k - 1):
            c, start = tile[q]
            if start:
                last = q
            f2 = ((f2 << 2) | c) & mask
            if q < i0 + k32 - 1:
                r2 = (r2 >> 2) | ((c ^ 1) << top)
        for i in range(i0, min(i0 + K.HLL_RUN, nw)):
            c, start = tile[i + k - 1]
            if start:
                last = i + k - 1
            f2 = ((f2 << 2) | c) & mask
            r2 = (r2 >> 2) | ((tile[i + k32 - 1][0] ^ 1) << top)
            out[i] = (last <= i, f2, r2)
    return out


def kernel_windows(codes, starts, fill, k):
    """Every window of a flat chunk as kernel K sees it, tile by tile:
    {window: (valid, f2, r2)}."""
    nwin = fill - k + 1
    out = {}
    for w0 in range(0, nwin, K.HLL_TILE):
        nw = min(nwin - w0, K.HLL_TILE)
        span = nw + k - 1
        tile = [[int(c) & 3, False] for c in codes[w0:w0 + span]]
        for s in starts:
            if w0 < s < w0 + span:  # the first start above w0 on
                tile[s - w0][1] = True
        for i, v in slide(tile, nw, k).items():
            out[w0 + i] = v
    return out


@pytest.mark.parametrize("k", [4, 8, 16, 20, 31, 32])
def test_ascii_words_of_every_group_match_jax(k):
    """The words of every window over a sequence that holds each of the
    256 4-code groups, both strands, against JAX's _window_bytes_words:
    the forward strand from r2, the reverse complement from f2."""
    groups = np.arange(256, dtype=np.uint8)
    codes = np.stack([(groups >> (2 * j)) & 3 for j in range(4)], 1)
    codes = np.concatenate([codes.reshape(-1), codes[::-1].reshape(-1)])
    fwd = [np.asarray(w) for w in JH._window_bytes_words(
        jnp.asarray(codes), k, rc=False)]
    rev = [np.asarray(w) for w in JH._window_bytes_words(
        jnp.asarray(codes), k, rc=True)]
    win = kernel_windows(codes, [], len(codes), k)
    assert len(win) == len(codes) - k + 1
    for i, (_, f2, r2) in win.items():
        for m in range((k + 7) // 8):
            assert ascii_word(r2, k, m) == int(fwd[m][i])
            assert ascii_word(f2, k, m) == int(rev[m][i])


@pytest.mark.parametrize("name", ["p4-k4", "p14-k20-palindromes",
                                  "p14-k32-palindromes",
                                  "p14-k33-palindromes",
                                  "p18-k64-palindromes",
                                  "p4-k20-short-reads",
                                  "p14-k20-tile-edges",
                                  "p18-k25-tile-edges",
                                  "p14-k20-one-window-tile",
                                  "p4-k25-one-window"])
def test_kernel_windows_match_jax(name):
    """On the card cases: each window's validity against JAX's flat mask,
    its palindrome test (f2 == r2) against JAX's rolling words, and for k
    <= 32 its murmur words against JAX's, both strands."""
    _, k, codes, starts, fill = graph_cases.hll_case_chunk(name)
    win = kernel_windows(codes, starts, fill, k)
    nwin = fill - k + 1
    assert sorted(win) == list(range(nwin))
    valid = K._flat_window_mask(torch.from_numpy(starts), fill, k, "cpu")
    c = jnp.asarray(codes[:fill])
    _, f2, r2 = JH.rolling_hash_windows(c, k)
    f2, r2 = np.asarray(f2), np.asarray(r2)
    pal = 0
    for i, (ok, f, r) in win.items():
        assert ok == bool(valid[i])
        assert (f == r) == (f2[i] == r2[i])
        pal += ok and f == r
    if "palindromes" in name and k % 2 == 0:
        assert pal > 0
    if k <= 32:
        fwd = [np.asarray(w) for w in JH._window_bytes_words(c, k, False)]
        rev = [np.asarray(w) for w in JH._window_bytes_words(c, k, True)]
        for i in range(0, nwin, max(1, nwin // 4000)):
            _, f, r = win[i]
            for m in range((k + 7) // 8):
                assert ascii_word(r, k, m) == int(fwd[m][i])
                assert ascii_word(f, k, m) == int(rev[m][i])


def test_edge_case_starts_lie_on_the_kernels_edges():
    """The tile-edge case puts read starts on a tile's first and last
    windows and on a run's edges, and the one-window cases have one
    window in their last tile and in their chunk."""
    _, k, _, starts, fill = graph_cases.hll_case_chunk("p14-k20-tile-edges")
    T, R = K.HLL_TILE, K.HLL_RUN
    for at in (T, 2 * T - 1, T + k - 1, 2 * T + k - 2, 5 * R, 7 * R - 1):
        assert at in set(starts.tolist())
    _, k, _, _, fill = graph_cases.hll_case_chunk("p14-k20-one-window-tile")
    assert (fill - k + 1) % T == 1
    _, k, _, _, fill = graph_cases.hll_case_chunk("p4-k25-one-window")
    assert fill - k + 1 == 1


# -- kernel J: the probe, then the commit of the open lanes ------------------


def _batches(seed, primes, m, kind):
    """Seeded batches as tests/test_torch_tagging.py makes them: (hashes
    u64 [m], valid bool [m], nvalid)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(3):
        if kind == "crowded":
            prod = int(np.prod([int(p) for p in primes]))
            low = rng.integers(0, 40, m, dtype=np.uint64)
            mult = rng.integers(0, 2**64 // prod, m, dtype=np.uint64)
            h = low + mult * np.uint64(prod)
        elif kind == "repeats":
            pool = rng.integers(0, 2**64, 50, dtype=np.uint64)
            h = pool[rng.integers(0, 50, m)]
        else:
            h = rng.integers(0, 2**64, m, dtype=np.uint64)
            h[::2] |= np.uint64(1 << 63)
        out.append((h, rng.random(m) < 0.85, m - 37 * b))
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64)
                            .view(np.int64).copy())


@pytest.mark.parametrize("half_set", [False, True])
@pytest.mark.parametrize("kind", ["crowded", "repeats", "full"])
@pytest.mark.parametrize("primes", [(1009,), (10007, 10009, 10037),
                                    (97, 89, 83, 79, 73, 71, 67, 61)])
def test_bit_split_matches_plain_and_jax(kind, primes, half_set):
    """Probe then commit of the open lanes, batch after batch, against
    bit_update_plain and JAX's _update_dispatch: flags, n_unique, tables;
    from zeroed tables and from tables with half their bits set."""
    m = 4096
    rng = np.random.default_rng(len(primes))
    split = K.init_tables("bit", primes, "cpu")
    if half_set:
        split.flat[:] = torch.from_numpy(
            rng.integers(0, 256, split.flat.shape[0], dtype=np.uint8))
    plain = K.BitTables(split.flat.clone(), primes)
    jt = tuple(jnp.asarray(t.numpy().copy()) for t in split)
    jn = jnp.zeros((), jnp.uint64)
    ns, np_ = torch.zeros(1, dtype=torch.int64), torch.zeros(
        1, dtype=torch.int64)
    for h, valid, nvalid in _batches(len(primes), primes, m, kind):
        v = torch.from_numpy(valid)
        mask = K.bit_probe_plain(primes, split.flat, _t(h), nvalid, v)
        flags = K.bit_commit_plain(primes, split.flat, ns, _t(h), mask)
        want = K.bit_update_plain(primes, plain, np_, _t(h), nvalid, v)
        live = valid & (np.arange(m) < nvalid)
        jt, jn, _, _, out = jax_pipeline._update_dispatch(
            "bit", primes, jt, jn, jnp.zeros((), jnp.uint64),
            jnp.zeros((), bool), jnp.asarray(h), jnp.asarray(live), False,
            True)
        assert torch.equal(flags, want)
        assert np.array_equal(flags.numpy(), np.asarray(out["event_new"]))
        assert int(ns) == int(np_) == int(jn)
        assert torch.equal(split.flat, plain.flat)
        for t, j in zip(split, jt):
            assert np.array_equal(t.numpy(), np.asarray(j))


def test_bit_probe_masks_only_valid_events_on_zero_bits():
    """A lane is open iff its event takes part and its bit is 0; events
    past nvalid get no mask."""
    primes = (13, 11)
    h = np.arange(40, dtype=np.uint64) * np.uint64(7)
    flat = K.init_tables("bit", primes, "cpu").flat
    valid = torch.from_numpy(np.arange(40) % 3 != 0)
    before = K.bit_probe_plain(primes, flat, _t(h), 30, valid)
    assert before.shape == (30,)
    assert torch.equal(before == 3, valid[:30])
    assert torch.equal(before == 0, ~valid[:30])
    K.bit_commit_plain(primes, flat, torch.zeros(1, dtype=torch.int64),
                       _t(h), before)
    after = K.bit_probe_plain(primes, flat, _t(h), 30, valid)
    assert int(after.sum()) == 0


BIT_CASES_CPU = ["crowded-4-tables", "high-hashes-8-tables",
                 "bits-already-set", "masked-nvalid", "half-set",
                 "mid-stream-repeats", "masked-most-set", "masked-few-set",
                 "32-tables", "32-tables-most-set"]


@pytest.mark.parametrize("name", BIT_CASES_CPU)
def test_bit_cases_split_matches_plain(name):
    """The card cases of graph_cases.BIT_CASES (all but the two of a
    million events) through the split mirror against bit_update_plain on
    the CPU, batch after batch."""
    primes, flat, batches = graph_cases.bit_case_batches(name)
    split = K.BitTables(torch.from_numpy(flat.copy()), primes)
    plain = K.BitTables(torch.from_numpy(flat.copy()), primes)
    ns, np_ = torch.zeros(1, dtype=torch.int64), torch.zeros(
        1, dtype=torch.int64)
    for h, valid, nvalid in batches:
        v = None if valid is None else torch.from_numpy(valid)
        mask = K.bit_probe_plain(primes, split.flat, _t(h), nvalid, v)
        flags = K.bit_commit_plain(primes, split.flat, ns, _t(h), mask)
        want = K.bit_update_plain(primes, plain, np_, _t(h), nvalid, v)
        assert torch.equal(flags, want)
        assert int(ns) == int(np_)
        assert torch.equal(split.flat, plain.flat)


def test_bit_cases_take_both_paths():
    """Between them the card cases send batches down both of J's paths,
    the probe (with lanes on set bits to settle) and every lane to the
    commit (over tables with bits set too), and a mask of 32 tables down
    each."""
    seen = set()
    for name in BIT_CASES_CPU:
        primes, flat, batches = graph_cases.bit_case_batches(name)
        tables = K.BitTables(torch.from_numpy(flat.copy()), primes)
        n_unique = torch.zeros(1, dtype=torch.int64)
        for h, valid, nvalid in batches:
            v = None if valid is None else torch.from_numpy(valid)
            if nvalid and int(tables.flat.sum()):
                probe = K.bit_sample_plain(primes, tables.flat, _t(h),
                                           nvalid, v)
                seen.add((probe, len(primes) == 32))
            K.bit_update_plain(primes, tables, n_unique, _t(h), nvalid, v)
    assert seen == {(True, False), (False, False), (True, True),
                    (False, True)}


def test_sample_constants_mirror_the_kernel():
    """BIT_SAMPLE and BIT_PROBE_MAX_OPEN, which bit_sample_plain applies,
    are the sample's kSample and kProbeMaxOpen in csrc/bit_update.cu."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                            "bit_update.cu")).read()
    got = {name: int(re.search(r"constexpr int %s = (-?\d+);" % name,
                               src).group(1))
           for name in ("kSample", "kProbeMaxOpen")}
    assert got == {"kSample": K.BIT_SAMPLE,
                   "kProbeMaxOpen": K.BIT_PROBE_MAX_OPEN}


@pytest.mark.parametrize("n,ntables", [(0, 1), (1000, 4), (37, 32)])
def test_probe_mask_reads_the_scratch_lane_masks(n, ntables):
    """graph_cases.probe_mask finds the lane masks where kernel J leaves
    them, in the min_old part of the scratch's plan, masks of 32 lanes
    (bit 31 set) included, and reads nothing of the other parts."""
    rng = np.random.default_rng(n)
    scratch = K.update_scratch(None, n, ntables, torch.device("cpu"))
    scratch.copy_(torch.from_numpy(rng.integers(
        0, 256, scratch.numel(), dtype=np.uint8)))
    want = rng.integers(0, 1 << ntables, n, dtype=np.int64)
    off, size = K.update_plan(n, ntables)[1]["min_old"]
    assert off + 4 * n <= off + size <= scratch.numel()
    scratch[off:off + 4 * n] = torch.from_numpy(
        want.astype(np.uint32).view(np.uint8))
    got = graph_cases.probe_mask(scratch, n, ntables)
    assert got.dtype == torch.int64
    assert got.tolist() == want.tolist()
    assert K.bit_open_lanes(got) == sum(bin(int(w)).count("1")
                                        for w in want)
