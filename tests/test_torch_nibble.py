"""The nibble layout of khmer_tpu_torch (the SmallCountgraph's 4-bit
counters, two a byte) against the JAX package, exactly, on the CPU: the
plain versions of kernels P, Q and R (nibble_update_plain,
nibble_gather_plain, nibble_pertable_plain) against JAX's make_update,
make_get and make_pertable_get on the nibble kind, the occupancy count
against make_nibble_occupied, the SmallCountgraph's state and sequence
count ops against JAX's SmallCountgraph (carried across by
from_numpy_state, and consumed from data/25k.fq.gz), the OXLI type-7 file
both ways, diginorm's per-table counts and counts_for_records on nibble
tables, and the knot repartition with a nibble counting table whose
counters saturate at 15. A neighbour probe of nibble tables is not ported
and raises."""

import gzip
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu import SmallCountgraph as JaxSmallCountgraph
from khmer_tpu.core import diginorm as jax_diginorm
from khmer_tpu.core import oxli_io as jax_oxli
from khmer_tpu.core import pipeline as jax_pipeline
from khmer_tpu.core import sketch_kernels as JK
from khmer_tpu.io.fastx import Record as JaxRecord
from khmer_tpu_torch import SmallCountgraph, load_countgraph
from khmer_tpu_torch.core import diginorm
from khmer_tpu_torch.core import oxli_io
from khmer_tpu_torch.core import partition as P
from khmer_tpu_torch.core import pipeline
from khmer_tpu_torch.core import sketch
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.io.fastx import Record
from khmer_tpu_torch.ops import host

from .test_torch_knots import (FREQUENCY, RADIUS, THRESHOLD, _jax_graph,
                               _port_graph, lump_reads)

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "25k.fq.gz")
KSIZE = 20


@pytest.fixture(scope="module", autouse=True)
def _two_walk_threads():
    """Two threads a walk pass: the workers share the cores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host, "walk_threads", lambda: 2)
        yield


def _t(h):
    """numpy u64 -> the int64 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(h, np.uint64).view(
        np.int64).copy())


# -- (a) the update, nibble_update_plain against make_update ------------------


def _bins(primes, bins, n_hashes, rng):
    """Hashes whose bin in table 0 is each of `bins` in turn: b + j * p0
    (j random), so they differ in the other tables."""
    p0 = primes[0]
    b = np.asarray(bins, np.uint64)
    j = rng.integers(0, 2**40, len(b)).astype(np.uint64)
    return (b + j * np.uint64(p0))[:n_hashes]


def _update_case(name):
    """(primes, [(hashes u64 [M], nvalid), ...]) of a named case."""
    rng = np.random.default_rng(len(name) * 31 + 7)
    if name == "one-hash-x40":
        # one hash 40 times in a chunk: its counters saturate at 15
        h = np.zeros(64, np.uint64)
        h[:40] = np.uint64(0xDEADBEEF12345)
        return (101, 103, 107), [(h, 40), (h, 40)]
    if name == "both-nibbles":
        # bins 2j (high nibble) and 2j + 1 (low) of one byte in one chunk,
        # in both orders, repeated, and across chunks
        primes = (1009, 1013)
        bins = [2 * j + o for j in range(0, 60, 3) for o in (0, 1)]
        bins += [2 * j + o for j in range(60, 120, 3) for o in (1, 0)]
        h = _bins(primes, bins * 3, 10**6, rng)
        rng.shuffle(h)
        return primes, [(h, len(h)), (h[::-1].copy(), len(h))]
    if name == "odd-primes-7-11":
        # the last byte's low nibble holds no counter
        h = rng.integers(0, 2**64, 256, dtype=np.uint64)
        return (7, 11), [(h[:100].copy(), 100), (h[100:].copy(), 156)]
    if name == "one-table":
        h = rng.integers(0, 2000, 4096).astype(np.uint64) * np.uint64(97)
        return (1999,), [(h, 4096), (h[::3].copy(), 1365)]
    if name == "twenty-tables":
        primes = tuple(K.get_n_primes_near_x(20, 400))
        h = rng.integers(0, 2**64, 3000, dtype=np.uint64)
        h[::5] = h[7]
        return primes, [(h, 3000), (h[::2].copy(), 1500)]
    if name == "zero-padded-tail":
        # events past nvalid take no part; zeros before it (the all-A
        # k-mer) do
        primes = (499, 503, 509, 521)
        out = []
        for nvalid in (1000, 777, 1):
            h = rng.integers(0, 2**64, 1024, dtype=np.uint64)
            h[nvalid:] = 0
            h[3:nvalid:50] = 0
            out.append((h, nvalid))
        return primes, out
    if name == "hashes-over-2-63":
        primes = (2003, 1999, 1997)
        pool = rng.integers(2**63, 2**64, 300, dtype=np.uint64)
        return primes, [(pool[rng.integers(0, 300, 2048)], 2048)
                        for _ in range(3)]
    raise KeyError(name)


UPDATE_CASES = ["one-hash-x40", "both-nibbles", "odd-primes-7-11",
                "one-table", "twenty-tables", "zero-padded-tail",
                "hashes-over-2-63"]


@pytest.mark.parametrize("name", UPDATE_CASES)
def test_nibble_update_plain_matches_jax(name):
    """Table bytes, n_unique and each event's new flag after every chunk,
    exactly."""
    primes, chunks = _update_case(name)
    upd = JK.make_update("nibble", primes, with_event_new=True)
    jt = JK.init_tables("nibble", primes)
    jn = jnp.uint64(0)
    tables = K.init_tables("nibble", primes, "cpu")
    assert [t.shape[0] for t in tables] == [p // 2 + 1 for p in primes]
    assert tables.flat.shape[0] == K.nibble_flat_size(primes)
    assert tables.flat.shape[0] % 4 == 0
    n_unique = torch.zeros(1, dtype=torch.int64)
    for h, nvalid in chunks:
        valid = np.arange(h.shape[0]) < nvalid
        jt, out = upd(jt, jn, jnp.asarray(h), jnp.asarray(valid))
        jn = out["n_unique"]
        flags = K.nibble_update_plain(primes, tables.flat, n_unique, _t(h),
                                      nvalid, with_event_new=True)
        assert int(n_unique) == int(jn)
        assert (flags.numpy()
                == np.asarray(out["event_new"])[:nvalid]).all()
        for got, want in zip(tables, jt):
            assert (got.numpy() == np.asarray(want)).all()
    if name == "one-hash-x40":  # its counters saturate at 15
        assert (K.nibble_pertable_plain(primes, tables.flat,
                                        _t(chunks[0][0][:1])) == 15).all()
    assert int(n_unique) > 0
    if name == "odd-primes-7-11":
        for t, p in zip(tables, primes):
            assert int(t[-1]) & 0x0F == 0  # counter p does not exist


def test_nibble_update_without_flags_returns_none():
    primes = (101,)
    tables = K.init_tables("nibble", primes, "cpu")
    n_unique = torch.zeros(1, dtype=torch.int64)
    assert K.nibble_update(primes, tables.flat, n_unique,
                           _t(np.arange(5, dtype=np.uint64)), 5) is None
    assert int(n_unique) == 5


# -- (b) the gathers, Q and R, and the occupancy ------------------------------


@pytest.fixture(scope="module")
def filled():
    """JAX nibble tables of (61, 59, 53) after three chunks of a small
    hash universe (most counters past 15), and a query set of hashes in
    and out of it, half of them >= 2^63."""
    primes = (61, 59, 53)
    rng = np.random.default_rng(5)
    upd = JK.make_update("nibble", primes)
    jt = JK.init_tables("nibble", primes)
    universe = rng.integers(0, 2**64, 400, dtype=np.uint64)
    for _ in range(3):
        h = universe[rng.integers(0, 400, 1500)]
        jt, _ = upd(jt, jnp.uint64(0), jnp.asarray(h),
                    jnp.ones(1500, bool))
    q = np.concatenate([universe, rng.integers(0, 2**64, 600,
                                               dtype=np.uint64)])
    q[::2] |= np.uint64(1 << 63)
    return primes, jt, q


def _port_tables(primes, jt):
    tables = K.init_tables("nibble", primes, "cpu")
    for dst, src in zip(tables, jt):
        dst.copy_(torch.from_numpy(np.asarray(src).copy()))
    return tables


def test_nibble_gathers_match_jax(filled):
    primes, jt, q = filled
    tables = _port_tables(primes, jt)
    got = K.nibble_gather_plain(primes, tables.flat, _t(q)).numpy()
    want = np.asarray(JK.make_get("nibble", primes)(jt, jnp.asarray(q)))
    assert (got == want).all() and got.max() == 15 and got.min() < 15
    # any shape, through the dispatcher
    got2 = K._gather_counts("nibble", primes, tables,
                            _t(q).reshape(20, 50)).numpy().ravel()
    assert (got2 == want).all()
    per = K.nibble_pertable_plain(primes, tables.flat, _t(q))
    assert per.dtype == torch.uint8 and per.shape == (3, q.shape[0])
    want = np.asarray(JK.make_pertable_get("nibble", primes)(
        jt, jnp.asarray(q)))
    assert (per.numpy() == want).all()
    assert (K.pertable_counts("nibble", primes, tables, _t(q)).numpy()
            == want).all()


def test_nibble_occupied_matches_jax(filled):
    primes, jt, _ = filled
    tables = _port_tables(primes, jt)
    for t, p, j in zip(tables, primes, jt):
        want = int(JK.make_nibble_occupied(p)(j))
        assert int(K.nibble_occupied(t)) == want
        assert want == JK.host_occupied("nibble", np.asarray(j))


def test_nibble_occupied_counts_in_slices(monkeypatch):
    rng = np.random.default_rng(2)
    t = torch.from_numpy(rng.integers(0, 256, 1001).astype(np.uint8))
    whole = int(K.nibble_occupied(t))
    monkeypatch.setattr(K, "OCCUPIED_SLICE", 64)
    assert int(K.nibble_occupied(t)) == whole


def test_nibble_kernels_take_cuda_tensors_only():
    primes = (11,)
    flat = torch.zeros(K.nibble_flat_size(primes), dtype=torch.uint8)
    h = torch.zeros(4, dtype=torch.int64)
    n = torch.zeros(1, dtype=torch.int64)
    for call in (lambda: K.nibble_update_cuda(primes, flat, n, h, 4),
                 lambda: K.nibble_gather_cuda(primes, flat, h),
                 lambda: K.nibble_pertable_cuda(primes, flat, h)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


# -- (c) the SmallCountgraph --------------------------------------------------


@pytest.fixture(scope="module")
def consumed():
    """JAX's SmallCountgraph(20, 1e5, 4) and the port's (CPU) after
    consume_seqfile of data/25k.fq.gz (tables full enough that counters
    saturate), and some of its reads."""
    jg = JaxSmallCountgraph(KSIZE, 1e5, 4)
    jr = jg.consume_seqfile(DATA)
    pg = SmallCountgraph(KSIZE, 1e5, 4, device="cpu")
    pr = pg.consume_seqfile(DATA)
    with gzip.open(DATA, "rt") as f:
        seqs = [line.strip() for line in itertools.islice(f, 1, 4 * 300, 4)]
    return jg, jr, pg, pr, seqs


def test_small_countgraph_consume_matches_jax(consumed):
    jg, jr, pg, pr, _ = consumed
    assert pr == jr
    assert pg.hashsizes() == jg.hashsizes()
    assert pg.n_unique_kmers() == jg.n_unique_kmers() > 0
    assert pg.n_occupied() == jg.n_occupied() > 0
    for got, want in zip(pg.get_raw_tables(), jg.get_raw_tables()):
        assert got.tobytes() == want.tobytes()
    assert max(b for t in pg.get_raw_tables() for b in t.tolist()) == 0xFF


def test_small_countgraph_counts_match_jax(consumed):
    jg, _, pg, _, seqs = consumed
    short = seqs[0][:KSIZE - 3]
    one = seqs[1][:KSIZE]
    for s in seqs[:60] + [one, seqs[2][:KSIZE + 1]]:
        assert pg.get_kmer_counts(s) == jg.get_kmer_counts(s)
        assert pg.get_min_count(s) == jg.get_min_count(s)
        assert pg.get_max_count(s) == jg.get_max_count(s)
        assert pg.get_median_count(s) == jg.get_median_count(s)
        for c in (1, 2, 8, 15, 16):
            assert pg.median_at_least(s, c) == jg.median_at_least(s, c)
            assert pg.trim_on_abundance(s, c) == jg.trim_on_abundance(s, c)
        kmer = s[:KSIZE]
        assert pg.get(kmer) == jg.get(kmer)
        assert pg.get(pg.hash(kmer)) == jg.get(jg.hash(kmer))
    assert pg.get_kmer_counts(short) == jg.get_kmer_counts(short) == []
    assert pg.get_min_count(short) == jg.get_min_count(short)
    assert pg.get_max_count(short) == jg.get_max_count(short)
    assert pg.trim_on_abundance(short, 2) == jg.trim_on_abundance(short, 2)
    for fn in ("get_median_count", "median_at_least"):
        args = (short,) if fn == "get_median_count" else (short, 2)
        with pytest.raises(ValueError):
            getattr(jg, fn)(*args)
        with pytest.raises(ValueError):
            getattr(pg, fn)(*args)
    q = np.concatenate([pg._hashes_for_sequence(s) for s in seqs[:100]])
    assert (pg.get_counts_for_hashes(q)
            == jg.get_counts_for_hashes(q)).all()


def test_small_countgraph_from_numpy_state(consumed):
    jg, _, _, _, seqs = consumed
    tables = [np.asarray(t) for t in jg.get_raw_tables()]
    pg = SmallCountgraph.from_numpy_state(
        KSIZE, jg.hashsizes(), tables, jg.n_unique_kmers(), 0,
        device="cpu")
    same = sketch.from_numpy_state(KSIZE, jg.hashsizes(), tables,
                                   jg.n_unique_kmers(), 0, device="cpu",
                                   kind="nibble")
    for g in (pg, same):
        assert type(g) is SmallCountgraph
        assert g.n_unique_kmers() == jg.n_unique_kmers()
        assert g.n_occupied() == jg.n_occupied()
        for s in seqs[:20]:
            assert g.get_kmer_counts(s) == jg.get_kmer_counts(s)
    # it goes on counting as a copy of JAX's does
    jcopy = JaxSmallCountgraph(KSIZE, 1, 1, primes=jg.hashsizes())
    jcopy.tables = tuple(jnp.asarray(t) for t in tables)
    jcopy._n_unique = jnp.uint64(jg.n_unique_kmers())
    for s in seqs[:30]:
        assert pg.consume(s) == jcopy.consume(s) == len(s) - KSIZE + 1
    assert pg.n_unique_kmers() == jcopy.n_unique_kmers()
    for got, want in zip(pg.get_raw_tables(), jcopy.get_raw_tables()):
        assert got.tobytes() == want.tobytes()


def test_small_countgraph_has_no_bigcount():
    g = SmallCountgraph(KSIZE, 1e3, 2, device="cpu")
    with pytest.raises(ValueError, match="Bigcount is not supported"):
        g.set_use_bigcount(True)
    g.set_use_bigcount(False)
    assert not g.get_use_bigcount()


def test_small_countgraph_probe_raises():
    """The neighbour probe of nibble tables is kernel N's nibble mode
    (its plain version here): no probe raises any more, and each reads the
    4-bit counters as JAX's SmallCountgraph does."""
    seq = "ACGTACGTTGCAGGCTAGCTAGCATCGA"
    g = SmallCountgraph(KSIZE, 1e3, 2, device="cpu")
    jg = JaxSmallCountgraph(KSIZE, 1e3, 2)
    for sketch in (g, jg):
        sketch.consume(seq)
        sketch.consume(seq[3:])
    assert sorted(g.neighbors(seq[:KSIZE])) == sorted(
        jg.neighbors(seq[:KSIZE]))
    assert g.kmer_degree(seq[:KSIZE]) == jg.kmer_degree(seq[:KSIZE])
    assert g.find_high_degree_nodes(seq) == jg.find_high_degree_nodes(seq)
    assert g.do_subset_partition(0, 0).count_partitions() == \
        jg.do_subset_partition(0, 0).count_partitions()
    P._Prober(g).close()


def test_small_countgraph_tags_as_jax():
    """Its tagged consume (kernel P's new flags) gives JAX's tags."""
    seqs = lump_reads(3, n_genomes=1, genome_len=800, n_reads=60)
    jg = JaxSmallCountgraph(KSIZE, 1e4, 2)
    pg = SmallCountgraph(KSIZE, 1e4, 2, device="cpu")
    for s in seqs:
        jg.consume_and_tag(s)
        pg.consume_and_tag(s)
    assert pg.all_tags == jg.all_tags and pg.all_tags
    assert pg.n_unique_kmers() == jg.n_unique_kmers()


# -- (d) OXLI type 7 ----------------------------------------------------------


def test_type7_file_matches_jax(consumed, tmp_path):
    jg, _, pg, _, seqs = consumed
    mine, theirs = tmp_path / "port.ct", tmp_path / "jax.ct"
    pg.save(str(mine))
    jg.save(str(theirs))
    blob = mine.read_bytes()
    assert blob == theirs.read_bytes()
    assert blob[5] == oxli_io.SAVED_SMALLCOUNT == 7
    assert len(blob) == 6 + 13 + sum(8 + p // 2 + 1 for p in pg.hashsizes())
    info = oxli_io.extract_countgraph_info(str(theirs))
    assert info == jax_oxli.extract_countgraph_info(str(theirs))
    assert info.ht_type == 7 and info.use_bigcount is None
    back = load_countgraph(str(theirs), device="cpu", small=True)
    assert type(back) is SmallCountgraph
    assert back.n_occupied() == jg.n_occupied()
    for s in seqs[:20]:
        assert back.get_kmer_counts(s) == jg.get_kmer_counts(s)
    again = tmp_path / "again.ct.gz"
    back.save(str(again))
    jax_back = jax_oxli.load_countgraph(str(again), small=True)
    assert [t.tobytes() for t in jax_back.get_raw_tables()] == \
        [t.tobytes() for t in jg.get_raw_tables()]


def test_type7_file_refused_as_a_countgraph(consumed, tmp_path):
    """A type-7 file raises where a type-1 Countgraph is asked for, and a
    type-1 file where a SmallCountgraph is, as in the JAX package."""
    jg, _, _, _, _ = consumed
    path = str(tmp_path / "small.ct")
    jg.save(path)
    with pytest.raises(OSError, match="Incorrect file format type 7") as e:
        load_countgraph(path, device="cpu")
    with pytest.raises(OSError) as j:
        jax_oxli.load_countgraph(path)
    assert str(e.value) == str(j.value)
    cg = sketch.Countgraph(KSIZE, 1e3, 2, device="cpu")
    cg.save(str(tmp_path / "big.ct"))
    with pytest.raises(OSError, match="Incorrect file format type 1"):
        load_countgraph(str(tmp_path / "big.ct"), device="cpu", small=True)


# -- (e) diginorm's counts and counts_for_records on nibble tables ------------


def test_pertable_counts_window_matches_jax(consumed):
    jg, _, pg, _, seqs = consumed
    L, B = 128, 64
    codes = np.zeros((B, L), np.uint8)
    lengths = np.zeros(B, np.int32)
    from khmer_tpu_torch.ops import hashing as H

    for i, s in enumerate(seqs[:B - 3]):
        c = H.encode_dna(s)
        codes[i, :len(c)] = c
        lengths[i] = len(c)
    fn = diginorm.make_pertable_counts("nibble", pg._primes, KSIZE,
                                       "twobit")
    hashes, per, valid = fn(pg.tables, torch.from_numpy(codes),
                            torch.from_numpy(lengths))
    jfn = jax_diginorm.make_pertable_counts("nibble", jg._primes, KSIZE,
                                            "twobit")
    jh, jper, jvalid = jfn(jg.tables, jnp.asarray(codes),
                           jnp.asarray(lengths))
    assert (hashes.numpy().view(np.uint64) == np.asarray(jh)).all()
    assert (per.numpy() == np.asarray(jper)).all()
    assert (valid.numpy() == np.asarray(jvalid)).all()


def test_counts_for_records_matches_jax(consumed, monkeypatch):
    """Per-read counts, reads shorter than k and one longer than 4096
    (JAX's scalar path) among them, windows cut small."""
    jg, _, pg, _, seqs = consumed
    long_read = "".join(seqs[:60])
    reads = seqs[:50] + ["ACGT", long_read] + seqs[50:90] + [""]
    monkeypatch.setattr(pipeline, "COUNTS_WINDOW", 16)
    got = list(pipeline.counts_for_records(
        pg, [Record(name="r%d" % i, sequence=s)
             for i, s in enumerate(reads)], window=16))
    monkeypatch.setenv("KHMER_TPU_ENGINE", "device")
    want = list(jax_pipeline.counts_for_records(
        jg, [JaxRecord(name="r%d" % i, sequence=s)
             for i, s in enumerate(reads)]))
    assert len(got) == len(want) == len(reads)
    for (r, c), (jr, jc) in zip(got, want):
        assert r.sequence == jr.sequence
        assert c.dtype == np.uint32 and (c == jc).all()
    assert len(got[51][1]) == len(long_read) - KSIZE + 1


def test_batched_normalizer_matches_jax(consumed):
    """BatchedNormalizer on a copy of the consumed tables, through several
    windows (its consumes committed by the nibble update)."""
    jg, _, _, _, seqs = consumed
    tables = [np.asarray(t) for t in jg.get_raw_tables()]
    pg = SmallCountgraph.from_numpy_state(KSIZE, jg.hashsizes(), tables,
                                          0, 0, device="cpu")
    jcopy = JaxSmallCountgraph(KSIZE, 1, 1, primes=jg.hashsizes())
    jcopy.tables = tuple(jnp.asarray(t) for t in tables)
    bundles = [[Record(name="a%d" % i, sequence=s)] for i, s in
               enumerate(seqs)]
    jbundles = [[JaxRecord(name="a%d" % i, sequence=s)] for i, s in
                enumerate(seqs)]
    norm = diginorm.BatchedNormalizer(pg, 10)
    jnorm = jax_diginorm.BatchedNormalizer(jcopy, 10)
    kept = jkept = 0
    for lo in range(0, len(seqs), 100):
        got = norm.process_window(bundles[lo:lo + 100])
        want = jnorm.process_window(jbundles[lo:lo + 100])
        assert [len(k) for k in got] == [len(k) for k in want]
        kept += sum(len(k) for k in got)
        jkept += sum(len(k) for k in want)
    assert kept == jkept and 0 < kept < len(seqs)
    assert pg.n_unique_kmers() == jcopy.n_unique_kmers()
    for got, want in zip(pg.get_raw_tables(), jcopy.get_raw_tables()):
        assert got.tobytes() == want.tobytes()


# -- (f) the knot repartition with a nibble counting table --------------------


@pytest.fixture(scope="module")
def small_lump():
    seqs = lump_reads(29, n_genomes=2, genome_len=2000, n_reads=700)
    with pytest.MonkeyPatch.context() as mp:
        jg = _jax_graph(mp, "auto", seqs)
    return seqs, jg


# counting tables (size a table, frequency, tables): shared bins; and so
# small, with a frequency past 15, that counters saturate and the stop
# tags come from the adds within a walk
NIBBLE_COUNTINGS = {"shared-bins": (3e4, FREQUENCY, 4),
                    "saturated": (61, 20, 4)}


@pytest.mark.parametrize("kind", sorted(NIBBLE_COUNTINGS))
def test_repartition_with_nibble_counting_matches_jax(kind, small_lump,
                                                      monkeypatch):
    """The stop tags, small tags, partition ids, counting tables and
    returned size of JAX's repartition (native engine) with a
    SmallCountgraph counting; where the counters saturate, evaluating
    with a byte table's saturation (255) would give other stop tags."""
    from khmer_tpu.core import sketch as jax_sketch

    from .test_torch_knots import _repartition_state

    _, jg = small_lump
    x, frequency, ntables = NIBBLE_COUNTINGS[kind]
    monkeypatch.setenv("KHMER_TPU_ENGINE", "auto")
    jg.stop_tags = set()
    jsubset = jg.do_subset_partition(0, 0)
    jcounting = jax_sketch.SmallCountgraph(32, x, ntables)
    jsize = jg.repartition_largest_partition(
        jcounting, RADIUS, THRESHOLD, frequency, subs=jsubset)
    want = _repartition_state(jg, jsubset, jcounting, jsize)
    jg.stop_tags = set()
    del jg.repart_small_tags

    def run(saturation=None):
        pg = _port_graph(jg, set())
        subset = pg.do_subset_partition(0, 0)
        counting = SmallCountgraph(32, x, ntables, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            if saturation is not None:
                evaluate = host.ExcursionWalk.evaluate
                mp.setattr(host.ExcursionWalk, "evaluate",
                           lambda self, base, primes, threshold, freq, _:
                           evaluate(self, base, primes, threshold, freq,
                                    saturation))
            size = pg.repartition_largest_partition(
                counting, RADIUS, THRESHOLD, frequency, subs=subset)
        return _repartition_state(pg, subset, counting, size)

    got = run()
    assert got[0] == want[0]
    assert got[1] == want[1] and got[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert got[4] == [np.asarray(t).tobytes() for t in jcounting.tables]
    if kind == "saturated":
        assert max(b for t in got[4] for b in t) == 0xFF
        assert run(saturation=255)[1] != want[1]
