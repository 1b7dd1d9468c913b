"""The port's trim-low-abund kernels' plain versions against the JAX
package, exactly (all state is integer): trim_window_plain (kernel G's)
against JAX's make_trim1_window, branch for branch with the trim
positions, tables and n_unique, on the windows of scripts/trim_cases.py
and on seeded ones; the port's ScanTrimmerState against JAX's over several
windows from the same non-empty tables; read_counts_plain (kernel H's)
against JAX's counts_for_records followed by trim_pos_from_counts and
median_at_least_from_counts, bigcount and thresholds above 255 included;
and Countgraph.median_at_least and trim_on_abundance against JAX's. JAX
runs on the CPU, as its own tests run it; the kernels themselves run on
the card (tests/test_torch_gpu_kernels.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import khmer_tpu
from khmer_tpu.core import diginorm_scan as jax_scan
from khmer_tpu.core import pipeline as jax_pipeline
from khmer_tpu.io.fastx import Record as JaxRecord
from khmer_tpu.utils import trimming as jax_trimming
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.diginorm_scan import (ScanTrimmerState,
                                                pack_reads,
                                                read_counts_window)
from khmer_tpu_torch.core.sketch import Countgraph
from khmer_tpu_torch.io.fastx import Record
from khmer_tpu_torch.ops.hashing import encode_dna
from khmer_tpu_torch.scripts import trim_cases
from khmer_tpu_torch.scripts.diginorm_cases import window as _window
from khmer_tpu_torch.utils import trimming

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)


def _flat(primes, tables):
    """The port's joined byte buffer of per-table u8 arrays."""
    flat = np.zeros(K.byte_flat_size(primes), dtype=np.uint8)
    for o, t in zip(K.byte_offsets(primes), tables):
        flat[o:o + len(t)] = t
    return torch.from_numpy(flat)


def _split(primes, flat):
    return [flat[o:o + p].numpy()
            for o, p in zip(K.byte_offsets(primes), primes)]


def _check_trim_window(primes, k, C, Z, D, flat, codes, lengths,
                       n_unique=5):
    """trim_window_plain against JAX make_trim1_window from the same
    tables: branch, trim_at, tables (JAX's u32 tables as min(t, 255) u8)
    and n_unique, exactly. Returns (branch, trim_at, new k-mers)."""
    B, L = codes.shape[0] // 2, codes.shape[1]
    fn = jax_scan.make_trim1_window(tuple(primes), k, "twobit", C, Z, D, B,
                                    L)
    jt, jn, jb, jtr = fn(
        tuple(jnp.asarray(t.astype(np.uint32))
              for t in _split(primes, flat)),
        jnp.asarray(np.uint64(n_unique)), jnp.asarray(codes),
        jnp.asarray(lengths))
    nu = torch.tensor([n_unique], dtype=torch.int64)
    branch, trim_at = K.trim_window_plain(
        primes, k, C, Z, D, flat, nu, torch.from_numpy(codes),
        torch.from_numpy(lengths))
    assert branch.dtype == trim_at.dtype == torch.int32
    assert branch.shape == (B,) and trim_at.shape == (B, 2)
    assert np.array_equal(branch.numpy(), np.asarray(jb))
    assert np.array_equal(trim_at.numpy(), np.asarray(jtr))
    for got, want in zip(_split(primes, flat), jt):
        assert np.array_equal(got, np.minimum(np.asarray(want), 255))
    assert int(nu) == int(jn)
    return branch, trim_at, int(nu) - n_unique


# the trim_cases windows whose tables a CPU test can hold (the others, 0.2
# and 4 GB of tables, run on the card only)
_HOST_CASES = [name for name, case in trim_cases.CASES.items()
               if K.byte_flat_size(case[0]) <= 1 << 24]


@pytest.mark.parametrize("name", _HOST_CASES)
def test_trim_window_plain_matches_jax_on_the_card_cases(name):
    """trim_window_plain against JAX make_trim1_window on the windows and
    tables that kernel G runs on the card (scripts/trim_cases.py)."""
    primes, k, C, Z, D, codes, lengths, fill = trim_cases.make_case(name)
    flat = trim_cases.fill_tables(primes, fill, "cpu")
    start = flat.clone()
    branch, trim_at, new = _check_trim_window(primes, k, C, Z, D, flat,
                                              codes, lengths)
    counts = np.bincount(branch.numpy(), minlength=3)
    if D is None:
        assert counts[0] == 0
    if name == "consume-lifts-trim":
        # every A read consumed and every read after it emitted; the
        # window-start tables would trim those at their first window shared
        # with A (or earlier, where one table's counter of a window is also
        # an A counter), the scan trims them later: at their length
        assert np.array_equal(branch.numpy(), np.tile([2, 1], 32))
        c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
        before, _ = K.read_counts_plain(primes, k, C, Z, start, c, n)
        rows = np.arange(2, codes.shape[0], 4)
        before, after = before.numpy()[rows], trim_at.numpy()[1::2, 0]
        assert (before <= k + codes.shape[1] // 4 - 1).all()
        assert (after > before).sum() >= 30
        assert (after == lengths[rows]).sum() >= 30
    if name == "short-mate":
        # a mate shorter than k trims to k - 1, as the JAX scan has it
        assert np.array_equal(trim_at.numpy()[:, 1], lengths[1::2] * 0 + 19)
    if name in ("C=300-Z=300", "diginorm-Z=300"):
        # no count reaches 300: only bundles with no read of k bases pass
        empty = (lengths < k).reshape(-1, 2).all(axis=1)
        assert np.array_equal(branch.numpy() == 1, empty & (D is None))
    if name == "counters-254-255":
        assert counts[2] == 0 and new == 0


@pytest.mark.parametrize("k,C,Z,D,L,lo,hi,ntables", [
    (20, 2, 20, None, 64, 0, 5, 3),
    (17, 3, 4, 6, 128, 0, 8, 3),
    (32, 255, 254, 255, 64, 250, 255, 3),
    (20, 300, 20, None, 64, 0, 3, 1),
    (20, 1, 2, 3, 64, 0, 0, 2),
    (20, -1, 0, 0, 64, 0, 2, 2),
])
def test_trim_window_plain_matches_jax_seeded(k, C, Z, D, L, lo, hi,
                                              ntables):
    """Seeded windows with tables of counts in [lo, hi], cutoffs past both
    ends of the u8 range and --diginorm on and off."""
    rng = np.random.default_rng(k * 1000 + C + 7 * ntables)
    primes = tuple(K.get_n_primes_near_x(ntables, 700))
    tables = [rng.integers(lo, hi + 1, p, dtype=np.uint8) for p in primes]
    codes, lengths = _window(rng, 96, L, k)
    _check_trim_window(primes, k, C, Z, D, _flat(primes, tables), codes,
                       lengths)


def test_trim_plan_follows_the_tables_alone():
    """Kernel G's shared memory depends on the number of tables only, fits
    a block, and its sub-chunks keep the map at most half full."""
    for ntables in (1, 2, 4, 31, 32):
        plan = K.trim_plan(ntables)
        assert plan["sub"] * ntables <= K.TRIM_MAP_SLOTS // 2
        assert plan["sub"] >= 1
        assert plan["smem"] <= 227 * 1024 - 1024
    with pytest.raises(ValueError):
        K.trim_plan(33)


def _reads(rng, n, genome, lo=30, hi=150):
    out = []
    for _ in range(n):
        m = int(rng.integers(lo, hi))
        s = int(rng.integers(0, len(genome) - m))
        out.append(genome[s:s + m])
    return out


def _bundles(rng, seqs, record):
    """Bundles of one or two records (a third of them pairs)."""
    bundles, i = [], 0
    while i < len(seqs):
        n = 2 if rng.random() < 1 / 3 and i + 1 < len(seqs) else 1
        bundles.append([record("r%d" % j, seqs[j]) for j in range(i, i + n)])
        i += n
    return bundles


def _seeded_graphs(rng, genome, n=60):
    jg = khmer_tpu.Countgraph(20, 3000, 3)
    for s in _reads(rng, n, genome):
        jg.consume(s)
    pg = Countgraph.from_numpy_state(
        20, jg.hashsizes(), [np.asarray(t) for t in jg.get_raw_tables()],
        jg.n_unique_kmers(), 0, device="cpu")
    return jg, pg


def _same_state(jg, pg):
    assert pg.n_unique_kmers() == jg.n_unique_kmers()
    for a, b in zip(pg.get_raw_tables(), jg.get_raw_tables()):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("C,Z,D", [(2, 3, None), (2, 4, 6), (300, 3, None)])
def test_scan_trimmer_matches_jax_engine(C, Z, D):
    """Several windows through the port's ScanTrimmerState and JAX's, from
    the same non-empty tables: the same branches and trim positions, and
    after every window the same tables and n_unique."""
    rng = np.random.default_rng(31 + C + Z)
    genome = "".join(rng.choice(list("ACGT"), 2500))
    seqs = _reads(rng, 600, genome)
    seqs[5], seqs[9] = "A" * 90, genome[:12]  # one k-mer; shorter than k
    jg, pg = _seeded_graphs(np.random.default_rng(3), genome)
    theirs = jax_scan.ScanTrimmerState(jg, C, Z, D, window=128)
    mine = ScanTrimmerState(pg, C, Z, D)
    jb = _bundles(np.random.default_rng(2), seqs, JaxRecord)
    pb = _bundles(np.random.default_rng(2), seqs, Record)
    seen = set()
    for s in range(0, len(pb), 128):
        want_b, want_t = theirs.process_window(jb[s:s + 128])
        got_b, got_t = mine.process_window(pb[s:s + 128])
        assert np.array_equal(got_b, want_b)
        assert np.array_equal(got_t, want_t)
        theirs.finalize()
        mine.finalize()
        _same_state(jg, pg)
        seen |= set(got_b.tolist())
    assert mine.scan_runs == -(-len(pb) // 128)
    assert seen >= {1, 2}


def test_scan_trimmer_long_read_runs_match_one_window():
    """A window holding a read longer than MAX_ROW_LEN splits into
    row_runs; the branches, trim positions and tables equal those of the
    same bundles scanned one at a time by trim_window_plain, the
    sequential rule (JAX's device engine cannot take such a read)."""
    rng = np.random.default_rng(41)
    genome = "".join(rng.choice(list("ACGT"), 9000))
    seqs = _reads(rng, 200, genome)
    seqs[120] = genome[100:5100]
    _, pg = _seeded_graphs(np.random.default_rng(6), genome)
    _, ref = _seeded_graphs(np.random.default_rng(6), genome)
    pb = _bundles(np.random.default_rng(4), seqs, Record)
    mine = ScanTrimmerState(pg, 2, 3)
    got_b, got_t = mine.process_window(pb)
    assert mine.scan_runs == 3
    for i, bundle in enumerate(pb):
        L = max(len(r.cleaned_seq) for r in bundle)
        codes = np.zeros((2, max(L, 27)), np.uint8)
        lengths = np.zeros(2, np.int32)
        for j, r in enumerate(bundle):
            codes[j, :len(r.cleaned_seq)] = encode_dna(r.cleaned_seq)
            lengths[j] = len(r.cleaned_seq)
        b, t = K.trim_window_plain(ref._primes, 20, 2, 3, None,
                                   ref.tables.flat, ref._n_unique,
                                   torch.from_numpy(codes),
                                   torch.from_numpy(lengths))
        assert int(b[0]) == got_b[i]
        assert t[0].tolist() == got_t[i].tolist()
    assert torch.equal(pg.tables.flat, ref.tables.flat)
    assert pg.n_unique_kmers() == ref.n_unique_kmers()


def _jax_counts(jg, seqs, monkeypatch, engine):
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    recs = [JaxRecord("q%d" % i, s) for i, s in enumerate(seqs)]
    return [c for _, c in jax_pipeline.counts_for_records(jg, recs)]


@pytest.mark.parametrize("engine", ["device", "auto"])
@pytest.mark.parametrize("C,X", [(2, 20), (1, 2), (255, 255), (300, 300),
                                 (256, 260), (0, 0)])
def test_read_counts_plain_matches_jax_counts_for_records(C, X, engine,
                                                          monkeypatch):
    """read_counts_plain against JAX's counts_for_records then
    trim_pos_from_counts and median_at_least_from_counts, on a countgraph
    whose counts pass 255 into the bigcount map; reads shorter than k, of
    exactly k, and of one k-mer many times included."""
    rng = np.random.default_rng(C * 7 + X)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    jg = khmer_tpu.Countgraph(20, 5000, 3)
    jg.set_use_bigcount(True)
    hot = genome[100:180]
    for s in _reads(rng, 200, genome) + [hot] * 300:
        jg.consume(s)
    assert jg._bigcounts
    pg = Countgraph.from_numpy_state(
        20, jg.hashsizes(), [np.asarray(t) for t in jg.get_raw_tables()],
        jg.n_unique_kmers(), 0, device="cpu", bigcounts=jg._bigcounts,
        use_bigcount=True)
    seqs = _reads(rng, 150, genome) + [hot, hot[:20], hot[:25], genome[:7],
                                       "A" * 60, hot + genome[:40]]
    counts = _jax_counts(jg, seqs, monkeypatch, engine)
    big = K.bigcount_table(pg._bigcounts, "cpu")
    recs = [Record("q%d" % i, s) for i, s in enumerate(seqs)]
    trims, n_ge = read_counts_window(pg, recs, C, X, big)
    for s, c, t, g in zip(seqs, counts, trims, n_ge):
        assert t == jax_trimming.trim_pos_from_counts(c, 20, C, len(s))
        assert g == int((c >= X).sum())
        assert (g >= int(0.5 + (len(s) - 19) / 2.0)) == \
            jax_trimming.median_at_least_from_counts(c, 20, X, len(s))
    if C == 300:  # the map moves some answers
        plain = read_counts_window(pg, recs, C, X)
        assert (plain[1] != n_ge).any()


def test_bigcount_table_orders_keys_as_unsigned():
    keys = {2**63 + 5: 300, 7: 400, 2**64 - 1: 500, 2**63 - 1: 600}
    k, v = K.bigcount_table(keys, "cpu")
    assert k.numpy().view(np.uint64).tolist() == sorted(keys)
    assert v.tolist() == [keys[h] for h in sorted(keys)]
    empty = K.bigcount_table({}, "cpu")
    assert empty[0].shape == empty[1].shape == (0,)


def test_read_counts_window_splits_long_reads_into_runs():
    """Reads longer than MAX_ROW_LEN run at rows of their own length; the
    answers equal one read_counts_plain call a read."""
    rng = np.random.default_rng(8)
    genome = "".join(rng.choice(list("ACGT"), 12000))
    pg = Countgraph(20, 4000, 2, device="cpu")
    pg.consume_seqfile([Record("g", genome[:6000])])
    seqs = _reads(rng, 40, genome) + [genome[1000:6000], genome[:9000]]
    recs = [Record("q%d" % i, s) for i, s in enumerate(seqs)]
    trims, n_ge = read_counts_window(pg, recs, 2, 1)
    for r, t, g in zip(recs, trims, n_ge):
        codes, lengths = pack_reads([r.cleaned_seq], len(r.cleaned_seq))
        want = K.read_counts_plain(pg._primes, 20, 2, 1, pg.tables.flat,
                                   torch.from_numpy(codes),
                                   torch.from_numpy(lengths))
        assert (t, g) == (int(want[0][0]), int(want[1][0]))


@pytest.mark.parametrize("use_bigcount", [False, True])
def test_countgraph_median_at_least_and_trim_on_abundance_match_jax(
        use_bigcount):
    rng = np.random.default_rng(21 + use_bigcount)
    genome = "".join(rng.choice(list("ACGT"), 2000))
    jg = khmer_tpu.Countgraph(20, 3000, 3)
    jg.set_use_bigcount(use_bigcount)
    hot = genome[500:600]
    for s in _reads(rng, 150, genome) + [hot] * 280:
        jg.consume(s)
    pg = Countgraph.from_numpy_state(
        20, jg.hashsizes(), [np.asarray(t) for t in jg.get_raw_tables()],
        jg.n_unique_kmers(), 0, device="cpu", bigcounts=jg._bigcounts,
        use_bigcount=use_bigcount)
    seqs = _reads(rng, 40, genome) + [hot, hot[:20], hot[:21], hot[:7]]
    for s in seqs:
        for cutoff in (1, 2, 5, 255, 270, 300):
            assert pg.trim_on_abundance(s, cutoff) == \
                jg.trim_on_abundance(s, cutoff)
            if len(s) < 20:
                with pytest.raises(ValueError):
                    pg.median_at_least(s, cutoff)
                continue
            assert pg.median_at_least(s, cutoff) == \
                jg.median_at_least(s, cutoff)


def test_trim_record_matches_jax():
    """utils/trimming.trim_record on the new Countgraph methods, variable
    coverage on and off, FASTA and FASTQ records."""
    rng = np.random.default_rng(23)
    genome = "".join(rng.choice(list("ACGT"), 1500))
    jg = khmer_tpu.Countgraph(20, 3000, 3)
    for s in _reads(rng, 120, genome):
        jg.consume(s)
    pg = Countgraph.from_numpy_state(
        20, jg.hashsizes(), [np.asarray(t) for t in jg.get_raw_tables()],
        jg.n_unique_kmers(), 0, device="cpu")
    for i, s in enumerate(_reads(rng, 30, genome) + [genome[:20]]):
        qual = "I" * len(s) if i % 2 else None
        for var, norm in ((False, None), (True, 2), (True, 6)):
            got, did = trimming.trim_record(pg, Record("r", s, qual), 2,
                                            var, norm)
            want, jdid = jax_trimming.trim_record(
                jg, JaxRecord("r", s, qual), 2, var, norm)
            assert did == jdid
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.sequence, got.quality) == (want.sequence,
                                                       want.quality)
