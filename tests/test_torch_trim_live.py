"""Kernel G's pre-pass rule on the CPU, against the JAX package: the
bundles trim_classify_plain settles keep its outputs, trim_window_plain
walks the live ones alone in stream order, and together they give
trim_window_plain's answer over the whole window and JAX
make_trim1_window's, bit for bit (branches, trim positions, tables and
n_unique): on every CPU-sized window of scripts/trim_cases.py and the
seeded windows of tests/test_torch_trim.py, with the set as built, with
every bit of it set (it may err only towards live) and with every bundle
live; on windows with no candidate and with nothing but candidates; and on
the three kinds of bundle the rule must get right, in stream order. JAX
runs on the CPU, as its own tests run it; the kernels themselves run on
the card (tests/test_torch_gpu_kernels.py)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from khmer_tpu.core import diginorm_scan as jax_scan
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.diginorm_scan import (ScanTrimmerState,
                                                pack_window, row_runs)
from khmer_tpu_torch.core.sketch import Countgraph
from khmer_tpu_torch.io.fastx import Record
from khmer_tpu_torch.ops.u64 import to_signed
from khmer_tpu_torch.scripts import trim_cases
from khmer_tpu_torch.scripts.diginorm_cases import SMALL, fill_tables
from khmer_tpu_torch.scripts.diginorm_cases import window as _window

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)


def _jax_window(primes, k, C, Z, D, flat, codes, lengths, n_unique=5):
    """JAX make_trim1_window from tables `flat`: (the port's u8 buffer
    holding JAX's u32 tables as min(t, 255), n_unique, branch, trim_at)
    as numpy."""
    B, L = codes.shape[0] // 2, codes.shape[1]
    fn = jax_scan.make_trim1_window(tuple(primes), k, "twobit", C, Z, D, B,
                                    L)
    tables = tuple(jnp.asarray(flat[o:o + p].numpy().astype(np.uint32))
                   for o, p in zip(K.byte_offsets(primes), primes))
    jt, jn, jb, jtr = fn(tables, jnp.asarray(np.uint64(n_unique)),
                         jnp.asarray(codes), jnp.asarray(lengths))
    out = flat.numpy().copy()
    for o, t in zip(K.byte_offsets(primes), jt):
        out[o:o + len(t)] = np.minimum(np.asarray(t), 255)
    return out, int(jn), np.asarray(jb), np.asarray(jtr)


def _split_walk(primes, k, C, Z, D, flat, codes, lengths, marks=None,
                live=None, n_unique=5):
    """The pre-pass's settled outputs, then trim_window_plain over the live
    bundles alone (all of them with `live` given): (branch, trim_at,
    tables, n_unique, candidates, live, pre-pass branch, pre-pass
    trim_at), tables and n_unique as the walk left them."""
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    cand, rule_live, branch, trim_at = K.trim_classify_plain(
        primes, k, C, Z, D, flat, c, n, marks)
    live = rule_live if live is None else live
    pre = branch.clone(), trim_at.clone()
    rows = torch.nonzero(live).flatten()
    pick = torch.stack([2 * rows, 2 * rows + 1], dim=1).flatten()
    walked = flat.clone()
    nu = torch.tensor([n_unique], dtype=torch.int64)
    b, t = K.trim_window_plain(primes, k, C, Z, D, walked, nu, c[pick],
                               n[pick])
    branch[rows] = b
    trim_at[rows] = t
    return (branch, trim_at, walked, int(nu), cand, live) + pre


def _whole(primes, k, C, Z, D, flat, codes, lengths, n_unique=5):
    walked = flat.clone()
    nu = torch.tensor([n_unique], dtype=torch.int64)
    b, t = K.trim_window_plain(primes, k, C, Z, D, walked,
                               nu, torch.from_numpy(codes),
                               torch.from_numpy(lengths))
    return b, t, walked, int(nu)


def _assert_same(split, whole, jax):
    branch, trim_at, tables, nu = split[:4]
    for got in (whole, jax):
        assert np.array_equal(branch.numpy(), np.asarray(got[0]))
        assert np.array_equal(trim_at.numpy(), np.asarray(got[1]))
        assert np.array_equal(tables.numpy(), np.asarray(got[2]))
        assert nu == got[3]


def _all_bits(primes, codes, k):
    B, W = codes.shape[0] // 2, codes.shape[1] - k + 1
    return torch.full((K.trim_plan(len(primes), B, W)["mark_words"],), -1,
                      dtype=torch.int32)


# the trim_cases windows whose tables a CPU test can hold
_HOST_CASES = [name for name, case in trim_cases.CASES.items()
               if K.byte_flat_size(case[0]) <= 1 << 24]


@functools.lru_cache(maxsize=None)
def _case(name):
    """(case, tables, trim_window_plain's answer, JAX's) of a trim case."""
    primes, k, C, Z, D, codes, lengths, fill = trim_cases.make_case(name)
    flat = fill_tables(primes, fill, "cpu")
    args = (primes, k, C, Z, D, flat, codes, lengths)
    whole = _whole(*args)
    jax = _jax_window(*args)
    jax = (jax[2], jax[3], jax[0], jax[1])
    return args, whole, jax


@pytest.mark.parametrize("mode", ["rule", "all-bits", "all-live"])
@pytest.mark.parametrize("name", _HOST_CASES)
def test_live_walk_matches_whole_window_and_jax(name, mode):
    """Settled outputs plus the walk over the live bundles alone equal
    trim_window_plain over the whole window and JAX make_trim1_window on
    the windows kernel G runs on the card: with the set as the pre-pass
    builds it, with every bit set (a set that errs makes more bundles live,
    never a different answer) and with every bundle live."""
    args, whole, jax = _case(name)
    primes, k, C, Z, D, flat, codes, lengths = args
    B = codes.shape[0] // 2
    marks = _all_bits(primes, codes, k) if mode == "all-bits" else None
    live = torch.ones(B, dtype=torch.bool) if mode == "all-live" else None
    split = _split_walk(*args, marks=marks, live=live)
    _assert_same(split, whole, jax)
    cand, got_live = split[4], split[5]
    assert bool((got_live | ~cand).all())  # every candidate is live
    if mode == "all-bits":
        rule = _split_walk(*args)
        assert bool((got_live | ~rule[5]).all())
    # a settled bundle's pre-pass outputs are its answer
    settled = ~got_live
    assert torch.equal(split[6][settled], split[0][settled])
    assert torch.equal(split[7][settled], split[1][settled])


@pytest.mark.parametrize("k,C,Z,D,L,lo,hi,ntables", [
    (20, 2, 20, None, 64, 0, 5, 3),
    (17, 3, 4, 6, 128, 0, 8, 3),
    (32, 255, 254, 255, 64, 250, 255, 3),
    (20, 300, 20, None, 64, 0, 3, 1),
    (20, 1, 2, 3, 64, 0, 0, 2),
    (20, -1, 0, 0, 64, 0, 2, 2),
])
def test_live_walk_matches_jax_seeded(k, C, Z, D, L, lo, hi, ntables):
    """The seeded windows of test_trim_window_plain_matches_jax_seeded
    (cutoffs past both ends of the u8 range, --diginorm on and off), with
    the set as built and with every bit set."""
    rng = np.random.default_rng(k * 1000 + C + 7 * ntables)
    primes = tuple(K.get_n_primes_near_x(ntables, 700))
    tables = [rng.integers(lo, hi + 1, p, dtype=np.uint8) for p in primes]
    codes, lengths = _window(rng, 96, L, k)
    flat = torch.from_numpy(np.concatenate(tables))
    args = (primes, k, C, Z, D, flat, codes, lengths)
    whole = _whole(*args)
    jt, jn, jb, jtr = _jax_window(*args)
    for marks in (None, _all_bits(primes, codes, k)):
        _assert_same(_split_walk(*args, marks=marks), whole,
                     (jb, jtr, jt, jn))


def test_window_with_no_candidate():
    """Tables at 250-255 and a trim coverage of 20: no bundle is a
    candidate, none is live, the walk adds nothing, and the pre-pass's
    outputs are the answer."""
    rng = np.random.default_rng(5)
    primes = SMALL
    flat = fill_tables(primes, (250, 255, 0), "cpu")
    codes, lengths = _window(rng, 128, 64, 20)
    args = (primes, 20, 2, 20, None, flat, codes, lengths)
    split = _split_walk(*args)
    jt, jn, jb, jtr = _jax_window(*args)
    _assert_same(split, _whole(*args), (jb, jtr, jt, jn))
    assert not split[4].any() and not split[5].any()
    assert torch.equal(split[2], flat) and split[3] == 5


def test_window_where_every_bundle_is_a_candidate():
    """Empty tables, every read present, a trim coverage of 1: every
    bundle is a candidate and live, and the walk is the whole scan."""
    rng = np.random.default_rng(6)
    primes = SMALL
    flat = torch.zeros(K.byte_flat_size(primes), dtype=torch.uint8)
    codes, lengths = _window(rng, 128, 64, 20, all_present=True)
    args = (primes, 20, 2, 1, 3, flat, codes, lengths)
    split = _split_walk(*args)
    jt, jn, jb, jtr = _jax_window(*args)
    _assert_same(split, _whole(*args), (jb, jtr, jt, jn))
    assert split[4].all() and split[5].all()
    assert (split[0] == 2).any() and (split[0] != 2).any()


def _pairs(name):
    """The pair and lift windows of trim_cases: (case args, split walk,
    JAX's answer); bundle 2i is read A, 2i + 1 the read after it."""
    args, whole, jax = _case(name)
    split = _split_walk(*args)
    _assert_same(split, whole, jax)
    return split


def test_non_candidate_whose_bad_window_an_earlier_consume_lifts():
    """consume-lifts-trim: each A is a candidate and consumed; the read
    after it is no candidate (it passes the trim coverage) but is live,
    and the walk moves its trim position from the pre-pass's."""
    branch, trim_at, _, _, cand, live, pre_b, pre_t = _pairs(
        "consume-lifts-trim")
    a, b = slice(0, None, 2), slice(1, None, 2)
    assert cand[a].all() and (branch[a] == 2).all()
    assert not cand[b].any() and live[b].all()
    assert ((pre_t[b] != trim_at[b]).any(dim=1)).sum() >= 30


def test_diginorm_non_candidate_moved_from_branch_1_to_0():
    """consume-lifts-digi: with --diginorm, the read after each consumed A
    passes the trim coverage but not the diginorm one at the window's
    start (pre-pass branch 1); A's adds lift it, and it takes branch 0."""
    branch, _, _, _, cand, live, pre_b, _ = _pairs("consume-lifts-digi")
    a, b = slice(0, None, 2), slice(1, None, 2)
    assert cand[a].all() and (branch[a] == 2).all()
    assert not cand[b].any() and live[b].all()
    assert (pre_b[b] == 1).all() and (branch[b] == 0).all()


def test_candidate_lifted_past_trim_coverage_is_not_consumed():
    """consume-lifts-candidate: the read after each consumed A is itself a
    candidate at the window's start (pre-pass branch 2); A's adds lift it
    past the trim coverage, so it takes branch 1 and adds nothing."""
    branch, _, tables, _, cand, live, pre_b, _ = _pairs(
        "consume-lifts-candidate")
    b = slice(1, None, 2)
    assert cand.all() and live.all()
    assert (pre_b[b] == 2).all() and (branch[b] == 1).all()
    # the tables are those of the A reads' adds alone
    primes, k, C, Z, D, flat, codes, lengths = _case(
        "consume-lifts-candidate")[0]
    rows = np.arange(codes.shape[0]).reshape(-1, 4)[:, :2].flatten()
    a_only = _whole(primes, k, C, Z, D, flat, codes[rows], lengths[rows])
    assert torch.equal(tables, a_only[2])


def test_mark_bit_is_the_kernels_product():
    """_mark_bit takes the top bits of the u64 product counter * 2^64 /
    golden ratio, as csrc/trim_prepass.cu mark_bit does."""
    fib = 0x9E3779B97F4A7C15
    counters = [0, 1, 12345, 2**31 + 7, 4 * 10**9 + 3, 2**40 - 1]
    for bits in (16, 26, 27):
        got = K._mark_bit(torch.tensor(counters, dtype=torch.int64), bits)
        want = [((c * fib) % 2**64) >> (64 - bits) for c in counters]
        assert got.tolist() == [to_signed(w) for w in want]


def test_trim_plan_sizes_the_set_by_the_window():
    """The pre-pass's set follows the window (at least 4 bits for each
    counter its candidates could mark, within TRIM_MARK_BITS), never the
    tables' size; the walk's shared memory follows the number of tables
    alone."""
    lo, hi = K.TRIM_MARK_BITS
    assert K.trim_plan(4)["mark_bits"] == lo
    plan = K.trim_plan(4, 16384, 109)
    assert plan["mark_bits"] == 26 and plan["mark_words"] == 2**26 // 32
    assert 2**plan["mark_bits"] >= 4 * 2 * 16384 * 109 * 4
    assert K.trim_plan(4, 10**6, 4077)["mark_bits"] == hi
    for ntables in (1, 4, 32):
        a, b = K.trim_plan(ntables), K.trim_plan(ntables, 16384, 109)
        assert a["smem"] == b["smem"] <= K.TRIM_SMEM_LIMIT
        assert a["group_events"] * ntables <= K.TRIM_GROUP_ITEMS
        assert a["sub"] * ntables <= K.TRIM_MAP_SLOTS // 2


def test_scan_trimmer_counts_candidates_live_bundles_and_groups():
    """ScanTrimmerState's counters over several windows equal the
    pre-pass's candidates and live bundles, and kernel G's groups of them
    (scan_groups), counted from the tables each window starts from."""
    rng = np.random.default_rng(12)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    recs = []
    for i in range(600):
        s = int(rng.integers(0, 2900))
        recs.append(Record("r%d" % i, genome[s:s + int(rng.integers(10,
                                                                    100))]))
    scan = ScanTrimmerState(Countgraph(20, 5e3, 3, device="cpu"), 2, 4)
    want = [0, 0, 0]
    for s in range(0, 600, 200):
        window = [[r] for r in recs[s:s + 200]]
        (_, _, L), = row_runs(window, 20)
        codes, lengths = pack_window(window, L)
        c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
        cand, live, _, _ = K.trim_classify_plain(
            scan._primes, 20, 2, 4, None, scan.graph.tables.flat, c, n)
        nw = torch.clamp(n.long() - 19, 0, L - 19)
        groups = K.scan_groups((nw[0::2] + nw[1::2]).tolist(),
                               torch.nonzero(live).flatten().tolist(), 3)
        want = [want[0] + int(cand.sum()), want[1] + int(live.sum()),
                want[2] + len(groups)]
        scan.process_window(window)
        got = [int(x) for x in (scan.candidates, scan.live, scan.groups)]
        assert got == want
    assert 0 < want[0] < want[1] < 600 and 0 < want[2] < want[1]
