"""The port's diginorm engine against the JAX package's, exactly (all
state is integer): the plain versions of kernels E and F
(sketch_kernels.med_ok_plain, diginorm_window_plain) against JAX's
make_med_ok and make_diginorm_window, decision for decision with the
tables and n_unique; the port's ScanNormalizer and BatchedNormalizer
against JAX's over several windows from the same non-empty tables; and
kernel F's shared-memory plan, which follows the window and never the
tables. Inputs are seeded numpy. JAX runs on the CPU, as its own tests
run it; the kernels themselves run on the card
(tests/test_torch_gpu_kernels.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import khmer_tpu
from khmer_tpu.core import diginorm as jax_diginorm
from khmer_tpu.core import diginorm_scan as jax_scan
from khmer_tpu.core import hostengine
from khmer_tpu.io.fastx import Record as JaxRecord
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.diginorm import BatchedNormalizer
from khmer_tpu_torch.core.diginorm_scan import (LONG_RUN_BYTES,
                                                ScanNormalizer,
                                                diginorm_window_plain,
                                                med_ok_plain, row_runs)
from khmer_tpu_torch.core.sketch import Countgraph, Nodegraph
from khmer_tpu_torch.io.fastx import Record
from khmer_tpu_torch.ops.u64 import umod
from khmer_tpu_torch.scripts import diginorm_cases
from khmer_tpu_torch.scripts.diginorm_cases import window as _window

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

SMEM_LIMIT = 232_448  # bytes of shared memory a block may have (H100)


def _flat(primes, tables):
    """The port's joined byte buffer of per-table u8 arrays."""
    flat = np.zeros(K.byte_flat_size(primes), dtype=np.uint8)
    for o, t in zip(K.byte_offsets(primes), tables):
        flat[o:o + len(t)] = t
    return torch.from_numpy(flat)


def _split(primes, flat):
    return [flat[o:o + p].numpy()
            for o, p in zip(K.byte_offsets(primes), primes)]


def _tables(rng, primes, low, high):
    return [rng.integers(low, high + 1, p, dtype=np.uint8) for p in primes]


@pytest.mark.parametrize("k,cutoff,L", [(17, 1, 64), (20, 5, 64),
                                        (20, 255, 128), (32, 20, 64),
                                        (20, 300, 64)])
def test_med_ok_plain_matches_jax(k, cutoff, L):
    rng = np.random.default_rng(k * 1000 + cutoff)
    primes = (1009, 1013, 1019)
    tables = _tables(rng, primes, 0, 255)
    # counts near the cutoff, where the test turns
    for t in tables:
        t[rng.choice(len(t), len(t) // 3)] = min(cutoff, 255)
    codes, lengths = _window(rng, 64, L, k)
    want = jax_scan.make_med_ok(primes, k, "twobit", cutoff, L)(
        tuple(jnp.asarray(t.astype(np.uint32)) for t in tables),
        jnp.asarray(codes), jnp.asarray(lengths))
    got = med_ok_plain(primes, k, cutoff, _flat(primes, tables),
                       torch.from_numpy(codes), torch.from_numpy(lengths))
    assert got.dtype == torch.bool and got.shape == (64,)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _jax_med_ok(primes, k, cutoff, flat, codes, lengths):
    tables = tuple(jnp.asarray(t.astype(np.uint32))
                   for t in _split(primes, flat))
    return np.asarray(jax_scan.make_med_ok(
        tuple(primes), k, "twobit", cutoff, codes.shape[1])(
        tables, jnp.asarray(codes), jnp.asarray(lengths)))


def _check_load_plan(primes, k, cutoff, flat, codes, lengths):
    """med_load_plan's rejections against med_ok_plain's and JAX
    make_med_ok's; returns (loaded, valid windows)."""
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    reject, loaded = K.med_load_plan(primes, k, cutoff, flat, c, n)
    assert reject.dtype == torch.bool
    assert reject.shape == (codes.shape[0] // 2,)
    assert torch.equal(reject, med_ok_plain(primes, k, cutoff, flat, c, n))
    assert np.array_equal(reject.numpy(),
                          _jax_med_ok(primes, k, cutoff, flat, codes,
                                      lengths))
    _, valid, _ = K._window_hashes(c, n, k)
    assert loaded.shape == (len(primes),) + valid.shape
    # only valid windows load, table 0 always, and never more than T each
    assert not bool((loaded & ~valid).any())
    assert torch.equal(loaded[0], valid)
    assert int(loaded.sum()) <= int(valid.sum()) * len(primes)
    return loaded, int(valid.sum())


@pytest.mark.parametrize("k,cutoff,L", [(17, 1, 64), (20, 5, 64),
                                        (20, 255, 128), (32, 20, 64),
                                        (20, 300, 64)])
def test_med_load_plan_matches_jax(k, cutoff, L):
    """Kernel E's staged rule (med_load_plan) rejects what JAX make_med_ok
    and med_ok_plain reject, on test_med_ok_plain_matches_jax's windows,
    loading table 0 for every valid window and the others for fewer."""
    rng = np.random.default_rng(k * 1000 + cutoff)
    primes = (1009, 1013, 1019)
    tables = _tables(rng, primes, 0, 255)
    for t in tables:
        t[rng.choice(len(t), len(t) // 3)] = min(cutoff, 255)
    codes, lengths = _window(rng, 64, L, k)
    _check_load_plan(primes, k, cutoff, _flat(primes, tables), codes,
                     lengths)


# the diginorm_cases windows whose tables a CPU test can hold (the others,
# 200 MB to 20 GB of tables, run on the card only)
_HOST_CASES = [name for name, case in diginorm_cases.CASES.items()
               if K.byte_flat_size(case[0]) <= 1 << 24]


@pytest.mark.parametrize("name", _HOST_CASES)
def test_med_load_plan_matches_jax_on_the_card_cases(name):
    """med_load_plan against med_ok_plain and JAX make_med_ok on the
    windows and tables that kernel E runs on the card
    (scripts/diginorm_cases.py), at their two exact extremes where the
    case is one."""
    primes, k, C, codes, lengths, fill = diginorm_cases.make_case(name)
    flat = diginorm_cases.fill_tables(primes, fill, "cpu")
    loaded, windows = _check_load_plan(primes, k, C, flat, codes, lengths)
    if name == "all-rejected":
        assert int(loaded.sum()) == windows * len(primes)
    if name in ("C=300", "32-tables-subchunks"):  # every count below C
        assert int(loaded.sum()) == windows
    if name == "one-round-1M-rows":
        assert K.med_plan(codes.shape[1], k)["bit_words"] == 0
        assert int(loaded.sum()) == windows * len(primes)


@pytest.mark.parametrize("ntables", [2, 3, 4, 32])
@pytest.mark.parametrize("L", [64, 1043, 1044])
def test_med_load_plan_loads_table_0_alone_when_it_fails_every_read(
        ntables, L):
    """Every table-0 counter below C: each present read fails on table 0,
    so kernel E loads exactly one counter a valid window and rejects no
    bundle that holds a present read."""
    rng = np.random.default_rng(ntables * 100 + L)
    primes = tuple(K.get_n_primes_near_x(ntables, 3000))
    tables = _tables(rng, primes, 0, 255)
    tables[0][:] = rng.integers(0, 7, primes[0], dtype=np.uint8)
    codes, lengths = _window(rng, 16, L, 20, genome_len=2 * L)
    loaded, windows = _check_load_plan(primes, 20, 7, _flat(primes, tables),
                                       codes, lengths)
    assert windows > 0 and int(loaded.sum()) == windows
    reject, _ = K.med_load_plan(primes, 20, 7, _flat(primes, tables),
                                torch.from_numpy(codes),
                                torch.from_numpy(lengths))
    present = (lengths >= 20).reshape(-1, 2).any(axis=1)
    assert np.array_equal(reject.numpy(), ~present)


@pytest.mark.parametrize("ntables", [1, 2, 4, 32])
@pytest.mark.parametrize("L", [64, 1043, 1044])
def test_med_load_plan_loads_every_table_when_every_count_meets_c(
        ntables, L):
    """Every counter at or above C: no read fails on table 0, so kernel E
    loads all T counters of every valid window (windows x T) and rejects
    every bundle."""
    rng = np.random.default_rng(ntables * 10 + L)
    primes = tuple(K.get_n_primes_near_x(ntables, 3000))
    tables = _tables(rng, primes, 7, 255)
    codes, lengths = _window(rng, 16, L, 20, genome_len=2 * L)
    flat = _flat(primes, tables)
    loaded, windows = _check_load_plan(primes, 20, 7, flat, codes, lengths)
    assert int(loaded.sum()) == windows * ntables
    reject, _ = K.med_load_plan(primes, 20, 7, flat, torch.from_numpy(codes),
                                torch.from_numpy(lengths))
    assert bool(reject.all())


def test_need_edge_case_holds_the_threshold_both_ways():
    """diginorm_cases' survivors-equal-need window holds bundles rejected
    with exactly the windows their reads need, reads one table-0 survivor
    short (failing, their mates' other tables never loaded) and reads that
    pass table 0 but fail on the last table."""
    primes, k, C, codes, lengths, fill = diginorm_cases.make_case(
        "survivors-equal-need")
    flat = diginorm_cases.fill_tables(primes, fill, "cpu")
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    hashes, valid, nvalid = K._window_hashes(c, n, k)
    need = K._min_required(nvalid)
    count = K.byte_gather_plain(primes, flat, hashes)
    table0 = flat[umod(hashes, primes[0])].to(torch.int32) >= C
    survive = (valid & table0).sum(dim=1)
    ge = (valid & (count >= C)).sum(dim=1)
    exact = ((survive == need) & (ge == need)).reshape(-1, 2).all(dim=1)
    short = (survive == need - 1) & (torch.arange(codes.shape[0]) % 2 == 0)
    late = (survive >= need) & (ge < need)
    reject, loaded = K.med_load_plan(primes, k, C, flat, c, n)
    assert int((exact & reject).sum()) >= 10
    assert int(short.sum()) >= 10 and int(late.sum()) >= 10
    # a read that fails on table 0 loads no other table, nor does its mate
    assert not bool(loaded[1:, short].any())
    assert not bool(loaded[1:, short.nonzero().flatten() + 1].any())
    assert not bool(reject[late.reshape(-1, 2).any(dim=1)].any())


def test_layout_arrays_are_made_once_for_each_set_of_primes():
    """The byte kernels' host arrays of primes and offsets are built once
    for a set of primes, whatever sequence type carries it."""
    primes = K.get_n_primes_near_x(4, 1e5)
    first = K._layout(list(primes))
    assert K._layout(tuple(primes)) is first
    assert list(first[0]) == [int(p) for p in primes]
    assert list(first[1]) == K.byte_offsets(primes)
    assert K._layout(primes[:3]) is not first


def test_med_plan_fits_a_block_and_follows_the_window():
    """Kernel E's tile (med_plan) fits a block's shared memory for rows of
    64 to a million codes, holds a bit for every window where it stages
    the tables, and falls back to one round only where two rows' bits do
    not fit."""
    for L in (64, 128, 1043, 1044, 4096, 9000, 20000, 10**5, 10**6):
        for k in (17, 20, 32):
            p = K.med_plan(L, k)
            W = L - k + 1
            assert 2 <= p["rows"] <= K.MED_MAX_ROWS and p["rows"] % 2 == 0
            assert p["seg"] % 32 == 0 and 32 <= p["seg"] <= K.MED_SEG
            assert p["seg"] >= min(W, K.MED_SEG)
            assert p["smem"] <= K.MED_SMEM_LIMIT
            per_row = 16 * (p["seg"] // 32 + 1) + p["seg"]
            assert p["smem"] == p["rows"] * (per_row + 4 * p["bit_words"])
            if p["bit_words"]:
                assert p["bit_words"] == -(-W // 32)
            else:
                assert 2 * (per_row + 4 * -(-W // 32)) > K.MED_SMEM_LIMIT
    assert K.med_plan(128, 32) == {"rows": K.MED_ROWS, "seg": 128,
                                   "bit_words": 4,
                                   "smem": K.MED_ROWS * (16 * 5 + 128 + 16)}
    with pytest.raises(ValueError):
        K.med_plan(19, 20)


def test_diginorm_med_counts_the_planned_loads_on_the_cpu():
    """diginorm_med on CPU tables with a load counter: med_load_plan's
    rejections and loads, added to the counter call after call."""
    rng = np.random.default_rng(44)
    primes = (1009, 1013, 1019)
    tables = _tables(rng, primes, 0, 12)
    flat = _flat(primes, tables)
    codes, lengths = _window(rng, 64, 128, 20)
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    loads = torch.zeros(1, dtype=torch.int64)
    for _ in range(2):
        reject = K.diginorm_med(primes, 20, 6, flat, c, n, loads)
        assert torch.equal(reject, med_ok_plain(primes, 20, 6, flat, c, n))
    _, loaded = K.med_load_plan(primes, 20, 6, flat, c, n)
    assert int(loads) == 2 * int(loaded.sum()) > 0
    assert torch.equal(K.diginorm_med(primes, 20, 6, flat, c, n), reject)


@pytest.mark.parametrize("k,cutoff,start", [
    (17, 1, "zero"),      # C = 1: the first add of a k-mer meets it
    (20, 5, "zero"),
    (20, 5, "near-255"),  # counters at 254 and 255 saturate
    (20, 255, "near-255"),
    (32, 3, "zero"),      # k = 32: every bit of the hash
    (20, 300, "zero"),    # C > 255: no read is ever ok, all kept
])
def test_diginorm_window_plain_matches_jax(k, cutoff, start):
    rng = np.random.default_rng(7 * k + cutoff)
    primes = (211, 223, 227)  # small: counters shared across k-mers
    B, L = 48, 64
    if start == "zero":
        tables = [np.zeros(p, dtype=np.uint8) for p in primes]
    else:
        tables = _tables(rng, primes, 250, 255)
        for t in tables:
            t[rng.choice(len(t), len(t) // 4)] = 0
    codes, lengths = _window(rng, B, L, k, genome_len=120)
    fn = jax_scan.make_diginorm_window(primes, k, "twobit", cutoff, B, L)
    j_tables, j_nu, j_keep = fn(
        tuple(jnp.asarray(t.astype(np.uint32)) for t in tables),
        jnp.asarray(17, dtype=jnp.uint64), jnp.asarray(codes),
        jnp.asarray(lengths))
    flat = _flat(primes, tables)
    nu = torch.tensor([17], dtype=torch.int64)
    keep = diginorm_window_plain(primes, k, cutoff, flat, nu,
                                 torch.from_numpy(codes),
                                 torch.from_numpy(lengths))
    assert np.array_equal(keep.numpy(), np.asarray(j_keep))
    assert int(nu) == int(j_nu)
    for mine, ref in zip(_split(primes, flat), j_tables):
        assert np.array_equal(mine, np.minimum(np.asarray(ref), 255))
    if cutoff > 255:
        present = (lengths >= k).reshape(-1, 2).any(axis=1)
        assert np.array_equal(keep.numpy(), present)


def test_scan_skips_what_phase_a_rejected():
    """With phase A's flags, the scan takes only the other bundles and
    gives what the full scan gives: a rejection under the window's
    starting tables is final."""
    rng = np.random.default_rng(3)
    primes = (401, 409)
    tables = _tables(rng, primes, 0, 8)
    codes, lengths = _window(rng, 64, 64, 20)
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    reject = med_ok_plain(primes, 20, 4, _flat(primes, tables), c, n)
    assert 0 < int(reject.sum()) < 64
    flat_a, flat_b = _flat(primes, tables), _flat(primes, tables)
    nu_a, nu_b = torch.zeros(1, dtype=torch.int64), torch.zeros(
        1, dtype=torch.int64)
    full = diginorm_window_plain(primes, 20, 4, flat_a, nu_a, c, n)
    part = K.diginorm_scan(primes, 20, 4, flat_b, nu_b, c, n, reject)
    assert torch.equal(full, part) and not part[reject].any()
    assert torch.equal(flat_a, flat_b) and int(nu_a) == int(nu_b)


def _reads(rng, n, genome, lo=30, hi=120):
    out = []
    for _ in range(n):
        m = int(rng.integers(lo, hi))
        s = int(rng.integers(0, len(genome) - m))
        out.append(genome[s:s + m])
    return out


def _bundles(rng, seqs, record):
    """Bundles of one or two records, as broken_paired_reader gives them;
    cleaned_seq set as clean_input_reads sets it."""
    bundles, i = [], 0
    while i < len(seqs):
        n = 2 if rng.random() < 0.4 and i + 1 < len(seqs) else 1
        b = []
        for s in seqs[i:i + n]:
            r = record("r%d" % i, s)
            r.cleaned_seq = s
            b.append(r)
        bundles.append(b)
        i += n
    return bundles


def _seeded_graphs(rng, genome):
    """A JAX Countgraph with some reads consumed, and the port's copy of
    its state (from_numpy_state): both engines start from the same
    non-empty tables and n_unique."""
    jg = khmer_tpu.Countgraph(20, 3000, 3)
    for s in _reads(rng, 40, genome):
        jg.consume(s)
    pg = Countgraph.from_numpy_state(
        20, jg.hashsizes(), [np.asarray(t) for t in jg.get_raw_tables()],
        jg.n_unique_kmers(), 0, device="cpu")
    return jg, pg


def _same_state(jg, pg):
    assert pg.n_unique_kmers() == jg.n_unique_kmers()
    for a, b in zip(pg.get_raw_tables(), jg.get_raw_tables()):
        assert np.array_equal(a, np.asarray(b))


def test_scan_normalizer_matches_jax_engines():
    """Several windows through the port's ScanNormalizer, JAX's
    ScanNormalizer and JAX's BatchedNormalizer: the same kept bundles,
    tables and n_unique after every window."""
    rng = np.random.default_rng(11)
    genome = "".join(rng.choice(list("ACGT"), 2500))
    seqs = _reads(rng, 700, genome)
    # a read repeating one k-mer, and a read shorter than k
    seqs[5], seqs[9] = "A" * 90, genome[:12]
    j1, pg = _seeded_graphs(np.random.default_rng(5), genome)
    j2, _ = _seeded_graphs(np.random.default_rng(5), genome)
    engines = [jax_scan.ScanNormalizer(j1, 4, window=128),
               jax_diginorm.BatchedNormalizer(j2, 4, window=128)]
    mine = ScanNormalizer(pg, 4)
    jb = _bundles(np.random.default_rng(2), seqs, JaxRecord)
    pb = _bundles(np.random.default_rng(2), seqs, Record)
    kept = 0
    for s in range(0, len(pb), 128):
        got = [len(x) for x in mine.process_window(pb[s:s + 128])]
        for eng in engines:
            assert [len(x) for x in eng.process_window(jb[s:s + 128])] \
                == got
        engines[0].finalize()
        mine.finalize()
        _same_state(j1, pg)
        _same_state(j2, pg)
        kept += sum(1 for x in got if x)
    assert 0 < kept < len(pb)


def test_scan_normalizer_long_read_window_matches_host_engine():
    """A window holding a read longer than MAX_ROW_LEN (4096) splits into
    runs (row_runs), the long read's at rows of its own length, which go
    through the same two phases in stream order. The JAX package's device
    engines cannot take such a read (their rows stop at 4096 codes;
    ROADMAP section 3), so the port is held to JAX's native host engine,
    the sequential reference, over windows before and after it."""
    rng = np.random.default_rng(12)
    genome = "".join(rng.choice(list("ACGT"), 9000))
    seqs = _reads(rng, 300, genome)
    seqs[200] = genome[100:5100]
    jg, pg = _seeded_graphs(np.random.default_rng(6), genome)
    ref = hostengine.NativeNormalizer(jg, 3)
    mine = ScanNormalizer(pg, 3)
    jb = _bundles(np.random.default_rng(4), seqs, JaxRecord)
    pb = _bundles(np.random.default_rng(4), seqs, Record)
    long_at = [i for i, b in enumerate(pb)
               if any(len(r.cleaned_seq) > 4096 for r in b)]
    assert len(long_at) == 1 and 100 <= long_at[0] < 200 < len(pb)
    for s in range(0, len(pb), 100):
        want = [len(x) for x in ref.process_window(jb[s:s + 100])]
        assert [len(x) for x in mine.process_window(pb[s:s + 100])] == want
        _same_state(jg, pg)
    assert mine.scan_runs == 2 + 3  # the long read's window in 3 runs


def _lens_bundles(lens):
    out = []
    for i, ls in enumerate(lens):
        b = []
        for n in ls:
            r = Record("r%d" % i, "A" * n)
            r.cleaned_seq = r.sequence
            b.append(r)
        out.append(b)
    return out


def test_row_runs_split_only_at_long_reads():
    """A window with no read longer than 4096 is one run at the ladder
    length of its longest read (at least k + 7); bundles holding a longer
    read run apart from the others, at their own longest read, several
    together while their padded codes fit LONG_RUN_BYTES."""
    assert row_runs(_lens_bundles([[90, 100], [30], [4096]]), 20) \
        == [(0, 3, 4096)]
    assert row_runs(_lens_bundles([[10], [5]]), 32) == [(0, 2, 64)]
    assert row_runs(_lens_bundles([[100], [200, 50]]), 20) == [(0, 2, 256)]
    assert row_runs(_lens_bundles([[100], [5000, 100], [9000], [100],
                                   [4097]]), 20) \
        == [(0, 1, 128), (1, 3, 9000), (3, 4, 128), (4, 5, 4097)]
    n = LONG_RUN_BYTES // (2 * 6000)
    runs = row_runs(_lens_bundles([[6000]] * (n + 1)), 20)
    assert runs == [(0, n, 6000), (n, n + 1, 6000)]
    assert row_runs([], 20) == []


def test_scan_normalizer_window_size_is_the_callers():
    """The engine takes whatever number of bundles a window holds: one
    window of 600 gives what windows of 1, 7 and 256 give."""
    rng = np.random.default_rng(21)
    genome = "".join(rng.choice(list("ACGT"), 2000))
    pb = _bundles(np.random.default_rng(3), _reads(rng, 600, genome),
                  Record)
    states = []
    for size in (600, 256, 7, 1):
        cg = Countgraph(20, 3000, 3, device="cpu")
        norm = ScanNormalizer(cg, 3)
        kept = []
        for s in range(0, len(pb), size):
            kept += [len(x) for x in norm.process_window(pb[s:s + size])]
        states.append((kept, cg.n_unique_kmers(), cg.tables.flat.clone()))
    for kept, nu, flat in states[1:]:
        assert kept == states[0][0] and nu == states[0][1]
        assert torch.equal(flat, states[0][2])


@pytest.mark.parametrize("kind", ["byte", "bit"])
def test_batched_normalizer_matches_jax(kind):
    rng = np.random.default_rng(13)
    genome = "".join(rng.choice(list("ACGT"), 1500))
    seqs = _reads(rng, 300, genome)
    if kind == "byte":
        jg = khmer_tpu.Countgraph(20, 2000, 3)
        pg = Countgraph(20, 2000, 3, device="cpu")
        pg.set_use_bigcount(True)
        jg.set_use_bigcount(True)
        cutoff = 6
    else:
        jg = khmer_tpu.Nodegraph(20, 4000, 3)
        pg = Nodegraph(20, 4000, 3, device="cpu")
        cutoff = 1
    ref = jax_diginorm.BatchedNormalizer(jg, cutoff, window=64)
    mine = BatchedNormalizer(pg, cutoff)
    jb = _bundles(np.random.default_rng(8), seqs, JaxRecord)
    pb = _bundles(np.random.default_rng(8), seqs, Record)
    for s in range(0, len(pb), 64):
        assert [len(x) for x in mine.process_window(pb[s:s + 64])] \
            == [len(x) for x in ref.process_window(jb[s:s + 64])]
    _same_state(jg, pg)


def _stale_scan(primes, k, cutoff, flat, n_unique, codes, lengths):
    """Kernel F as it would run if it skipped its overlay: each group of
    scan_groups tested and added against the tables as the group found
    them, each kept bundle writing min(found + hits, 255) over what the
    earlier ones of its group wrote. Returns keep, bool [B]."""
    hashes, valid, nvalid = K._window_hashes(codes, lengths, k)
    nw = valid.sum(dim=1)
    B = codes.shape[0] // 2
    keep = torch.zeros(B, dtype=torch.bool)
    min_req = K._min_required(nvalid).tolist()
    present = (lengths >= k).tolist()
    offsets = K.byte_offsets(primes)
    groups = K.scan_groups((nw[0::2] + nw[1::2]).tolist(), list(range(B)),
                           len(primes))
    for group in groups:
        found = flat.clone()
        for b in group:
            rows = (2 * b, 2 * b + 1)
            counters = torch.cat([torch.stack(
                [umod(hashes[r, :int(nw[r])], p) + o
                 for p, o in zip(primes, offsets)]) for r in rows], dim=1)
            old = found[counters]
            at_least = (old.amin(dim=0) >= cutoff if old.shape[1]
                        else torch.zeros(0, dtype=torch.bool))
            n0 = int(nw[rows[0]])
            ok0 = not present[rows[0]] or int(at_least[:n0].sum()) \
                >= min_req[rows[0]]
            ok1 = not present[rows[1]] or int(at_least[n0:].sum()) \
                >= min_req[rows[1]]
            if ok0 and ok1:
                continue
            keep[b] = True
            added = found.clone()
            K._consume_bundle(added, n_unique, counters, old)
            flat[counters] = added[counters]
    return keep


@pytest.mark.parametrize("name", diginorm_cases.GROUP_CASES)
def test_group_cases_catch_a_scan_that_skips_the_overlay(name):
    """Each window of diginorm_cases.GROUP_CASES (which kernel F must pass
    on the card) forms groups of several candidates, and a scan that read
    each group's counters as the group found them (_stale_scan) gets its
    keep flags, tables or n_unique wrong: so each case would catch a
    kernel F that skipped its overlay. The L=9000 window also holds
    bundles too large for a group, which run alone."""
    primes, k, C, codes, lengths, fill = diginorm_cases.make_case(name)
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    flat0 = diginorm_cases.fill_tables(primes, fill, "cpu")
    _, valid, _ = K._window_hashes(c, n, k)
    nw = valid.sum(dim=1)
    nev = (nw[0::2] + nw[1::2]).tolist()
    B = codes.shape[0] // 2
    groups = K.scan_groups(nev, list(range(B)), len(primes))
    assert max(len(g) for g in groups) > 1
    alone = [g for g in groups
             if nev[g[0]] > K.DIGI_GROUP_ITEMS // len(primes)]
    assert bool(alone) == (name == "L=9000-grouped-and-alone")
    flat_p, flat_s = flat0.clone(), flat0.clone()
    nu_p = torch.zeros(1, dtype=torch.int64)
    nu_s = nu_p.clone()
    groups_p = torch.zeros(1, dtype=torch.int64)
    keep_p = diginorm_window_plain(primes, k, C, flat_p, nu_p, c, n,
                                   n_groups=groups_p)
    keep_s = _stale_scan(primes, k, C, flat_s, nu_s, c, n)
    assert int(groups_p) == len(groups)
    assert 0 < int(keep_p.sum()) < B
    assert (not torch.equal(keep_p, keep_s) or not torch.equal(flat_p, flat_s)
            or int(nu_p) != int(nu_s))


def _round16(n):
    return -(-n // 16) * 16


@pytest.mark.parametrize("k", [17, 20, 32])
@pytest.mark.parametrize("ntables", [1, 2, 3, 4, 20, 32])
def test_diginorm_plan_follows_the_window_not_the_tables(k, ntables):
    """Kernel F's only scratch is its shared memory: the union of the
    group's overlay (4 B of claim, 4 B of hits, 4 B of lowest event and
    2 B of value a slot; 8 B of counter and 2 B of slot and owner bit an
    item; 1 B of new flag an event) and a lone bundle's
    map (16 B a slot, its hashes, 8 B for each of 2 (L - k + 1) windows,
    and a sub-chunk's flags), then the tile's candidate list. It follows
    the row length and the number of tables, never the table size (the
    plan takes none), and fits a block at every row length of the
    ladder."""
    S, G, M = K.DIGI_OVERLAY_SLOTS, K.DIGI_GROUP_ITEMS, K.DIGI_MAP_SLOTS
    T = K.DIGI_SCAN_THREADS
    prev = None
    for L in (64, 128, 256, 512, 1024, 2048, 4096):
        plan = K.diginorm_plan(L, k, ntables)
        group, alone, tile = plan["group"], plan["alone"], plan["tile"]
        assert list(group) == ["claim", "keys", "hits", "first", "values",
                               "slots", "fresh"]
        assert list(alone) == ["keys", "hashes", "hits", "first", "fresh"]
        assert list(tile) == ["reads", "list", "starts"]
        gev = plan["group_events"]
        assert gev == G // ntables and gev * ntables <= G == S // 2
        assert group["claim"] + group["hits"] + group["first"] \
            + group["values"] == 14 * S
        assert group["keys"] == 4 * group["slots"] == 8 * G
        assert group["fresh"] == gev
        assert alone["hashes"] == 16 * (L - k + 1)
        assert plan["hash_words"] == 0
        assert alone["keys"] + alone["hits"] + alone["first"] == 16 * M
        assert plan["sub"] * ntables <= M // 2
        assert alone["fresh"] == plan["sub"] >= 64
        assert tile == {"reads": 8 * T, "list": 4 * T, "starts": 4 * (T + 1)}
        assert plan["union"] == _round16(max(sum(group.values()),
                                             sum(alone.values())))
        assert plan["smem"] == plan["union"] + sum(tile.values()) \
            <= K.DIGI_SMEM_LIMIT < SMEM_LIMIT
        if prev is not None:
            assert plan["smem"] >= prev
            if sum(alone.values()) > sum(group.values()):
                assert plan["smem"] > prev
        prev = plan["smem"]


@pytest.mark.parametrize("ntables", [1, 3, 4, 32])
def test_diginorm_plan_moves_long_rows_hashes_to_a_row_sized_buffer(
        ntables):
    """Rows too long for a lone bundle's hashes to fit the block's shared
    memory keep them in a device buffer of 2 (L - k + 1) words, sized by
    the row; the shared memory then holds the overlay or the map and the
    tile's words, at any row length."""
    base = K.diginorm_plan(64, 20, ntables)
    fixed_alone = sum(base["alone"].values()) - 16 * (64 - 20 + 1)
    group, tile = sum(base["group"].values()), sum(base["tile"].values())
    for L in (5000, 9000, 10000, 10500, 20000, 1 << 20):
        plan = K.diginorm_plan(L, 20, ntables)
        words = 2 * (L - 20 + 1)
        assert plan["smem"] <= K.DIGI_SMEM_LIMIT < SMEM_LIMIT
        assert plan["group"] == base["group"]
        if _round16(max(group, fixed_alone + 8 * words)) + tile \
                <= K.DIGI_SMEM_LIMIT:
            assert plan["hash_words"] == 0
            assert plan["alone"]["hashes"] == 8 * words
        else:
            assert plan["hash_words"] == words
            assert "hashes" not in plan["alone"]
            assert plan["smem"] == _round16(max(group, fixed_alone)) + tile
    assert K.diginorm_plan(9000, 20, 4)["hash_words"] == 0
    assert K.diginorm_plan(20000, 20, 4)["hash_words"] > 0


@pytest.mark.parametrize("ntables", [1, 3, 4, 32])
def test_scan_groups_fill_the_overlay_and_run_large_bundles_alone(ntables):
    """Kernel F's groups (scan_groups): from each group's first candidate,
    in order, as many as keep the group's events within group_events =
    DIGI_GROUP_ITEMS // ntables, and at least one; a bundle of more events
    (its events x tables exceed half the overlay) is a group alone; no
    group crosses a tile of DIGI_SCAN_THREADS bundles."""
    gev = K.diginorm_plan(128, 20, ntables)["group_events"]
    assert gev * ntables <= K.DIGI_GROUP_ITEMS < (gev + 1) * ntables
    assert K.scan_groups([gev, 0, 1], [0, 1, 2], ntables) == [[0, 1], [2]]
    assert K.scan_groups([1, gev + 1, 1], [0, 1, 2], ntables) \
        == [[0], [1], [2]]
    # bundle 2 is no candidate; the group of 0 and 1 is full
    assert K.scan_groups([gev - 1, 1, 0, 5], [0, 1, 3], ntables) \
        == [[0, 1], [3]]
    T = K.DIGI_SCAN_THREADS
    nev = [1] * (T + 40)
    got = K.scan_groups(nev, list(range(T + 40)), ntables)
    assert all(g[0] // T == g[-1] // T for g in got)
    assert sum(got, []) == list(range(T + 40))
    assert max(len(g) for g in got) == min(gev, T)
    assert K.scan_groups([], [], ntables) == []


def test_diginorm_plan_refuses_rows_without_a_kmer():
    with pytest.raises(ValueError):
        K.diginorm_plan(16, 17, 4)
    with pytest.raises(ValueError):
        K.diginorm_plan(64, 20, 33)


def test_min_required_is_the_halved_count():
    """median_at_least's float32 threshold equals the kernels' integer
    (nvalid + 1) / 2 over every count a row of the ladder holds."""
    nvalid = torch.arange(0, 1 << 16)
    assert torch.equal(K._min_required(nvalid), (nvalid + 1) // 2)


def test_scan_normalizer_requires_byte_storage():
    with pytest.raises(ValueError, match="byte storage"):
        ScanNormalizer(Nodegraph(20, 1000, 2, device="cpu"), 5)
