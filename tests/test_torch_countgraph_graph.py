"""The port's Countgraph as a de Bruijn graph (khmer_tpu_torch) against the
JAX package on the CPU: kernel A's per-event new flags (plain version)
against make_update(..., with_event_new=True); kernel N's plain version
against make_neighbors_fn's byte kind and, with a band, against JAX's
counts with their bigcount fix-up; the tagged consume (tags, .tagset, .ct,
n_unique) under both JAX engines (KHMER_TPU_ENGINE=auto, the native host
tier; =device, the flat device path); do_subset_partition and
do_subset_partition_with_abundance (.pmap bytes) against JAX's native
engine everywhere and its level walk where the two agree; the abundance
walk against its plain queue walk; and the sequence API.

Tolerance: exact everywhere (integer state, float32 sums taken in the
same order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu import Countgraph as JaxCountgraph
from khmer_tpu.core import graphmixin as JG
from khmer_tpu.core import partition as JP
from khmer_tpu.core import sketch_kernels as JK
from khmer_tpu.ops import hashing as JH
from khmer_tpu_torch.core import partition as P
from khmer_tpu_torch.core import pipeline
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.sketch import Countgraph, median_avg_stddev
from khmer_tpu_torch.ops import host
from khmer_tpu_torch.scripts import countgraph_cases

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

ENGINES = ["auto", "device"]
K_SIZE = 20


@pytest.fixture(scope="module", autouse=True)
def _two_walk_threads():
    """Two threads a walk pass: the workers share the cores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host, "walk_threads", lambda: 2)
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64)
                            .view(np.int64).copy())


def graph_reads(seed, n=600, genome_len=4000, length=100, sub=0.01):
    """Seeded reads of two random genomes with substitutions, one read in
    forty a run of lowercase bases or Ns, some shorter than k, some of
    1,500 bases (longer than the tests' dense chunk), and one read 300
    times (its k-mers past 255: bigcount entries)."""
    rng = np.random.default_rng(seed)
    genomes = [rng.integers(0, 4, genome_len) for _ in range(2)]
    out = []
    for i in range(n):
        g = genomes[i % 2]
        size = 1500 if i % 97 == 5 else (int(rng.integers(5, K_SIZE))
                                         if i % 53 == 7 else length)
        s = int(rng.integers(0, genome_len - size))
        read = g[s:s + size].copy()
        hit = rng.random(size) < sub
        read[hit] = rng.integers(0, 4, int(hit.sum()))
        seq = "".join("ATCG"[c] for c in read)
        if i % 40 == 3:
            seq = seq[:30] + seq[30:60].lower() + "N" * 3 + seq[63:]
        out.append(seq)
    out += [out[10]] * 300
    return out


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    path = tmp_path_factory.mktemp("cg") / "reads.fa"
    with open(path, "w") as f:
        for i, seq in enumerate(graph_reads(3)):
            f.write(">r%d\n%s\n" % (i, seq))
    return str(path)


def _jax_graph(engine, path, density=None, x=2e5):
    os.environ["KHMER_TPU_ENGINE"] = engine
    try:
        g = JaxCountgraph(K_SIZE, x, 4)
        g.set_use_bigcount(True)
        if density:
            g._set_tag_density(density)
        got = g.consume_seqfile_and_tag(path)
    finally:
        del os.environ["KHMER_TPU_ENGINE"]
    return g, tuple(int(v) for v in got)


@pytest.fixture(scope="module")
def jax_graphs(reads):
    """{engine: (JAX Countgraph tagged from the reads, (reads, new))}."""
    return {engine: _jax_graph(engine, reads) for engine in ENGINES}


def _port_graph(jg):
    """The port's Countgraph on the CPU holding a JAX Countgraph's
    state."""
    return Countgraph.from_numpy_state(
        jg.ksize(), jg._primes, [np.asarray(t) for t in jg.tables],
        int(jg.n_unique_kmers()), 0, device="cpu",
        bigcounts=jg._bigcounts, use_bigcount=jg._use_bigcount,
        all_tags=jg.all_tags, stop_tags=jg.stop_tags,
        tag_density=jg._tag_density)


# -- kernel A's per-event new flags --------------------------------------


@pytest.mark.parametrize("primes,m,pool", [
    ((7, 5, 3, 2), 4096, 1 << 30),   # counters shared within a chunk
    ((100003, 100019, 100043, 100049), 4096, 11),  # bins saturating in one
    ((100003, 100019, 100043, 100049), 8192, 1 << 40),
    ((1009,), 4096, 5000),
])
def test_byte_update_flags_match_jax_make_update(primes, m, pool):
    """Flags, tables, n_unique and bigcount map after each chunk of a
    sequence, against JAX's make_update(byte, with_bigcount=True,
    with_event_new=True) (its v2 path, whose collision resolution takes
    the shared and saturated bins, at m = 4096), with nvalid < m."""
    rng = np.random.default_rng(len(primes) + pool % 97)
    values = rng.integers(0, 2**64, min(pool, 4 * m), dtype=np.uint64)
    pg = Countgraph(K_SIZE, 1, 1, primes=primes, device="cpu")
    pg.set_use_bigcount(True)
    jg = JaxCountgraph(K_SIZE, 1, 1, primes=primes)
    jg.set_use_bigcount(True)
    update = JK.make_update("byte", primes, True, True)
    for c in range(3):
        h = values[rng.integers(0, len(values), m)]
        nvalid = m - 97 * c
        valid = np.arange(m) < nvalid
        jg.tables, out = update(jg.tables, jg._n_unique, jnp.asarray(h),
                                jnp.asarray(valid))
        jg._n_unique = out["n_unique"]
        jg._absorb_saturation(out)
        flags = pg._update(_t(h), nvalid, with_event_new=True)
        assert np.array_equal(flags.numpy(),
                              np.asarray(out["event_new"])[:nvalid])
        assert not np.asarray(out["event_new"])[nvalid:].any()
        assert pg.n_unique_kmers() == int(jg.n_unique_kmers())
        for a, b in zip(pg.get_raw_tables(), jg.get_raw_tables()):
            assert np.array_equal(a, np.asarray(b))
        assert pg._bigcounts == {int(a): int(b)
                                 for a, b in jg._bigcounts.items()}
    assert pg.n_unique_kmers() > 0
    assert pg._bigcounts or pool > 100


# -- kernel N's plain version -----------------------------------------------


@pytest.mark.parametrize("k", [1, 20, 32])
def test_byte_neighbors_plain_matches_jax(k):
    """The presence byte of kernel N's plain version against JAX's
    make_neighbors_fn, byte kind, on tables 60% set."""
    rng = np.random.default_rng(k)
    primes = tuple(K.get_n_primes_near_x(4, 9000))
    size = K.byte_flat_size(primes)
    flat = np.where(rng.random(size) < 0.6, rng.integers(1, 256, size),
                    0).astype(np.uint8)
    views = tuple(jnp.asarray(flat[o:o + p])
                  for o, p in zip(K.byte_offsets(primes), primes))
    f = np.array([int(v) % 4 ** k for v in
                  rng.integers(0, 2**64, 500, dtype=np.uint64)], np.uint64)
    r = P.revcomp_bits(f, k)
    present = np.asarray(JG.make_neighbors_fn("byte", primes, k)(
        views, jnp.asarray(f), jnp.asarray(r))[3])
    masks = K.byte_neighbors_plain(primes, torch.from_numpy(flat), _t(f),
                                   _t(r), k).numpy()
    assert (((masks[:, None] >> np.arange(8)) & 1).astype(bool)
            == present).all()
    assert 0 < present.mean() < 1 or k == 1


@pytest.mark.parametrize("band", [(1, 255), (2, 200), (2, 255), (255, 255),
                                  (1, 300), (256, 65535), (0, 3)])
def test_byte_neighbors_band_matches_jax_counts(band, jax_graphs):
    """Kernel N's band byte (and presence byte) on the consumed graph,
    whose repeated read put k-mers past 255 into the bigcount map, against
    JAX's get_counts_for_hashes (bigcount fix-up) of each neighbour."""
    jg, _ = jax_graphs["device"]
    assert jg._bigcounts
    pg = _port_graph(jg)
    hashes = np.array(sorted(jg.all_tags)[:300]
                      + sorted(jg._bigcounts)[:100], np.uint64)
    f = np.array([JH._hash_scalar(JH.reverse_hash(int(h), K_SIZE),
                                  K_SIZE)[1] for h in hashes], np.uint64)
    r = P.revcomp_bits(f, K_SIZE)
    _, _, nc, present = [np.asarray(a) for a in jg.neighbors_batch(f, r)]
    counts = jg.get_counts_for_hashes(nc.ravel()).reshape(nc.shape)
    big = K.bigcount_table(pg._bigcounts, "cpu")
    pres, got = K.byte_neighbors_plain(pg._primes, pg.tables.flat, _t(f),
                                       _t(r), K_SIZE, band, big)
    bits = lambda m: ((m.numpy()[:, None] >> np.arange(8)) & 1).astype(bool)
    assert (bits(pres) == present).all()
    want = (counts >= max(band[0], 1)) & (counts <= band[1])
    assert (bits(got) == want).all()
    if band == (256, 65535):
        assert want.any()


# -- the tagged consume -------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("source", ["path", "parser"])
def test_tagged_consume_matches_jax(engine, source, reads, jax_graphs,
                                    tmp_path, monkeypatch):
    """Tags, (reads, new k-mers), n_unique, bigcount map, .ct and .tagset
    bytes of the port's tagged consume (kernel A's flags) against JAX's,
    with a dense chunk of 777 k-mers so that reads straddle chunks."""
    from khmer_tpu_torch.io.fastx import FastxParser

    jg, jgot = jax_graphs[engine]
    monkeypatch.setattr(pipeline, "DENSE_CHUNK", 777)
    pg = Countgraph(K_SIZE, 2e5, 4, device="cpu")
    pg.set_use_bigcount(True)
    got = pg.consume_seqfile_and_tag(reads if source == "path"
                                     else FastxParser(reads))
    assert got == jgot
    assert pg.all_tags == set(int(t) for t in jg.all_tags)
    assert pg.n_unique_kmers() == int(jg.n_unique_kmers())
    assert pg._bigcounts == {int(a): int(b) for a, b in jg._bigcounts.items()}
    for name, save in (("g.ct", "save"), ("g.tagset", "save_tagset")):
        getattr(pg, save)(str(tmp_path / ("p" + name)))
        getattr(jg, save)(str(tmp_path / ("j" + name)))
        assert ((tmp_path / ("p" + name)).read_bytes()
                == (tmp_path / ("j" + name)).read_bytes())
    assert pg.n_tags() > 10


def test_consume_and_tag_matches_jax(reads):
    """consume_and_tag, read by read, against JAX's (device engine)."""
    from khmer_tpu_torch.io.fastx import FastxParser

    os.environ["KHMER_TPU_ENGINE"] = "device"
    try:
        jg = JaxCountgraph(K_SIZE, 2e5, 4)
        pg = Countgraph(K_SIZE, 2e5, 4, device="cpu")
        for _, rec in zip(range(150), FastxParser(reads)):
            assert pg.consume_and_tag(rec.sequence) == \
                jg.consume_and_tag(rec.sequence)
    finally:
        del os.environ["KHMER_TPU_ENGINE"]
    assert pg.all_tags == set(int(t) for t in jg.all_tags)
    assert pg.n_unique_kmers() == int(jg.n_unique_kmers())


# -- partitions ---------------------------------------------------------------


def _pmap_bytes(subset, path):
    subset.save_partitionmap(str(path))
    return path.read_bytes()


@pytest.mark.parametrize("band", [None, (2, 200), (1, 65535), (3, 65535)])
@pytest.mark.parametrize("stop_big", [False, True])
def test_partition_matches_jax(band, stop_big, jax_graphs, tmp_path):
    """do_subset_partition and do_subset_partition_with_abundance: .pmap
    bytes against JAX's native engine (auto) on the graph JAX built, and
    against its level walk (device) without the cut of big traversals,
    where the two JAX engines agree. (A band whose top lies from 255 up to
    below a bigcount entry splits the JAX engines:
    test_bigcount_band_engines.)"""
    for engine, (jg, _) in jax_graphs.items():
        if engine == "device" and stop_big:
            continue
        os.environ["KHMER_TPU_ENGINE"] = engine
        try:
            pg = _port_graph(jg)
            if band is None:
                js = jg.do_subset_partition(0, 0, False, stop_big)
                ps = pg.do_subset_partition(0, 0, False, stop_big)
            else:
                js = jg.do_subset_partition_with_abundance(
                    band[0], band[1], stop_big_traversals=stop_big)
                ps = pg.do_subset_partition_with_abundance(
                    band[0], band[1], stop_big_traversals=stop_big)
            assert (_pmap_bytes(ps, tmp_path / "p.pmap")
                    == _pmap_bytes(js, tmp_path / "j.pmap"))
            assert ps.count_partitions() == js.count_partitions()
        finally:
            del os.environ["KHMER_TPU_ENGINE"]


@pytest.mark.parametrize("band", [(2, 200), (1, 2), (2, 255), (0, 0)])
@pytest.mark.parametrize("stop_big", [False, True])
def test_abundance_walk_matches_plain(band, stop_big, jax_graphs):
    """The C++ walk with kernel N's band against find_all_tags_plain's
    queue walk, which tests each popped node's count, from every tag, with
    every fifth tag a stop tag: a child out of the band is queued and
    popped (it meets the size test) but never kept."""
    jg, _ = jax_graphs["auto"]
    pg = _port_graph(jg)
    tags = np.array(sorted(pg.all_tags), np.uint64)
    pg.stop_tags = set(int(t) for t in tags[::5])
    r = P.revcomp_bits(tags, K_SIZE)
    got = P.find_all_tags_batch(pg, tags, r, True, stop_big,
                                count_range=band)
    want = P.find_all_tags_plain(pg, list(zip(tags.tolist(), r.tolist())),
                                 True, stop_big, count_range=band)
    assert [set(g.tolist()) for g in got] == want
    assert sum(map(len, want)) > 0 or band == (0, 0)


def test_truncate_on_abundance_one_traversal(jax_graphs):
    """find_all_tags_truncate_on_abundance, one traversal, against JAX's
    (native engine) and the plain queue walk."""
    jg, _ = jax_graphs["auto"]
    pg = _port_graph(jg)
    for tag in sorted(pg.all_tags)[:40:4]:
        _, f, r = JH._hash_scalar(JH.reverse_hash(int(tag), K_SIZE), K_SIZE)
        got = P.find_all_tags_truncate_on_abundance(pg, f, r, 2, 200, False,
                                                    True)
        os.environ["KHMER_TPU_ENGINE"] = "auto"
        try:
            want = JP.find_all_tags_truncate_on_abundance(jg, f, r, 2, 200,
                                                          False, True)
        finally:
            del os.environ["KHMER_TPU_ENGINE"]
        assert got == set(int(t) for t in want)
        assert [got] == P.find_all_tags_plain(pg, [(f, r)], False, True,
                                              count_range=(2, 200))


def test_bigcount_band_engines(tmp_path):
    """A band whose top is 255 on a graph with bigcount entries: the port
    reads a saturated count through the bigcount map, as the reference's
    ByteStorage::get_count and JAX's Python engine do, so a k-mer counted
    300 times is out of (1, 255). JAX's native engine reads the counter
    alone (255, in the band), so its partitions differ here; the port
    equals JAX's level walk and its own plain queue walk."""
    rng = np.random.default_rng(9)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 3000))
    path = tmp_path / "sat.fa"
    with open(path, "w") as f:
        for i in range(0, 2800, 20):
            f.write(">r%d\n%s\n" % (i, genome[i:i + 150]))
        for i in range(300):  # the middle of the genome past 255
            f.write(">s%d\n%s\n" % (i, genome[1400:1520]))
    maps = {}
    for engine in ENGINES:
        jg, _ = _jax_graph(engine, str(path), density=10, x=1e5)
        pg = _port_graph(jg)
        os.environ["KHMER_TPU_ENGINE"] = engine
        try:
            js = jg.do_subset_partition_with_abundance(1, 255)
        finally:
            del os.environ["KHMER_TPU_ENGINE"]
        maps[engine] = _pmap_bytes(js, tmp_path / ("%s.pmap" % engine))
    ps = pg.do_subset_partition_with_abundance(1, 255)
    mine = _pmap_bytes(ps, tmp_path / "p.pmap")
    assert mine == maps["device"]
    assert maps["auto"] != maps["device"]
    tags = np.array(sorted(pg.all_tags), np.uint64)
    r = P.revcomp_bits(tags, K_SIZE)
    got = P.find_all_tags_batch(pg, tags, r, count_range=(1, 255))
    want = P.find_all_tags_plain(pg, list(zip(tags.tolist(), r.tolist())),
                                 count_range=(1, 255))
    assert [set(g.tolist()) for g in got] == want


# -- the sequence API ----------------------------------------------------------


def test_sequence_api_matches_jax(jax_graphs, reads):
    """consume, get_kmers, get_kmer_hashes(_as_hashset), get_kmer_counts
    (kernel H's counts mode with the bigcount map), get_min_count,
    get_max_count, get_median_count, get_tags_and_positions,
    find_high_degree_nodes, extract_unique_paths, find_all_tags_list and
    neighbors against JAX."""
    from khmer_tpu_torch.io.fastx import FastxParser

    jg, _ = jax_graphs["device"]
    pg = _port_graph(jg)
    seqs = [rec.sequence for _, rec in zip(range(60), FastxParser(reads))]
    seqs.append(graph_reads(3)[10])  # its k-mers are past 255
    os.environ["KHMER_TPU_ENGINE"] = "device"
    try:
        for seq in seqs:
            assert pg.get_kmers(seq) == jg.get_kmers(seq)
            assert pg.get_kmer_hashes(seq) == jg.get_kmer_hashes(seq)
            assert (pg.get_kmer_hashes_as_hashset(seq)
                    == jg.get_kmer_hashes_as_hashset(seq))
            assert pg.get_kmer_counts(seq) == jg.get_kmer_counts(seq)
            assert pg.get_min_count(seq) == jg.get_min_count(seq)
            assert pg.get_max_count(seq) == jg.get_max_count(seq)
            if len(seq) >= K_SIZE:
                assert pg.get_median_count(seq) == jg.get_median_count(seq)
                kmer = seq[:K_SIZE].upper().replace("N", "A")
                assert (sorted(pg.find_all_tags_list(kmer))
                        == sorted(jg.find_all_tags_list(kmer)))
                assert pg.neighbors(kmer) == jg.neighbors(kmer)
            assert (pg.get_tags_and_positions(seq)
                    == jg.get_tags_and_positions(seq))
            assert (pg.find_high_degree_nodes(seq)
                    == jg.find_high_degree_nodes(seq))
            assert (pg.extract_unique_paths(seq, 30, 0.5)
                    == jg.extract_unique_paths(seq, 30, 0.5))
        assert max(pg.get_max_count(s) for s in seqs) > 255
        for seq in seqs[:20]:
            if len(seq) >= K_SIZE:
                assert pg.consume(seq) == jg.consume(seq)
        with pytest.raises(ValueError):
            pg.consume("ACGT")
        with pytest.raises(ValueError):
            pg.get_median_count("ACGT")
    finally:
        del os.environ["KHMER_TPU_ENGINE"]
    assert pg.n_unique_kmers() == int(jg.n_unique_kmers())
    for a, b in zip(pg.get_raw_tables(), jg.get_raw_tables()):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_median_avg_stddev_is_the_sequential_float32_sum(seed):
    """The port's median_avg_stddev (float32 cumsum) against JAX's
    one-count-at-a-time loop, on counts whose pairwise sum would round
    otherwise."""
    from khmer_tpu.core.sketch import _median_avg_stddev

    rng = np.random.default_rng(seed)
    for n in (1, 2, 7, 1000, 20000):
        counts = rng.integers(0, 65536, n).astype(np.uint32)
        counts[::3] = rng.integers(0, 5, len(counts[::3]))
        assert median_avg_stddev(counts) == _median_avg_stddev(counts)


def test_counts_for_records_matches_jax(jax_graphs, reads):
    """counts_for_records (kernel H's counts mode, rows packed in runs of
    one length, the bigcount map on the host) against JAX's, on reads of
    every length, in windows of 50 records."""
    from khmer_tpu.core import pipeline as jax_pipeline
    from khmer_tpu.io.fastx import FastxParser as JaxParser
    from khmer_tpu_torch.io.fastx import FastxParser

    jg, _ = jax_graphs["device"]
    pg = _port_graph(jg)
    os.environ["KHMER_TPU_ENGINE"] = "device"
    try:
        want = [(rec.name, c.tolist()) for rec, c in
                jax_pipeline.counts_for_records(jg, JaxParser(reads))]
    finally:
        del os.environ["KHMER_TPU_ENGINE"]
    got = [(rec.name, c.tolist()) for rec, c in
           pipeline.counts_for_records(pg, FastxParser(reads), window=50)]
    assert got == want
    assert any(max(c, default=0) > 255 for _, c in got)
    assert any(not c for _, c in got)


def test_from_numpy_state_carries_the_graph(jax_graphs):
    jg, _ = jax_graphs["auto"]
    pg = _port_graph(jg)
    assert pg.all_tags == set(int(t) for t in jg.all_tags)
    assert pg._tag_density == jg._tag_density
    assert pg.get_use_bigcount() and pg._bigcounts
    assert pg.n_unique_kmers() == int(jg.n_unique_kmers())


@pytest.mark.parametrize("name", list(countgraph_cases.NBR_CASES))
def test_nbr_cases_probe_what_they_name(name):
    """Kernel N's cases (scripts/countgraph_cases.py) on the CPU: their
    nodes, the presence the plain version finds (some and not all where
    the tables are partly set) and, where the case has one, a bigcount
    table whose entries are saturated neighbours."""
    k, _, _, n, fill = countgraph_cases.NBR_CASES[name]
    primes, kk, flat, f, r, big = countgraph_cases.nbr_inputs(name, "cpu")
    nodes = f.shape[0]
    assert kk == k and r.shape[0] == nodes
    assert nodes == (n * (100 - k + 1) if fill == "graph" else n)
    present, band = K.byte_neighbors_plain(primes, flat, f, r, k, (2, 200),
                                           big)
    bits = np.unpackbits(present.numpy()).mean() if nodes else 0
    if fill in ("dense", "near-full", "saturated", "high", "graph") \
            and k > 1 and nodes > 1:
        assert 0 < bits < 1
    if fill == "full":
        assert bits == 1 and not band.any()
    if fill in ("saturated", "high", "full"):
        assert big is not None and big[0].shape[0] > 0


def test_byte_probe_floors_count_one_value_at_a_time():
    """byte_probe_floors (N's two sector floors and its loads) against a
    count one neighbour and one table at a time in Python."""
    from khmer_tpu_torch.ops.u64 import umin

    primes, k, flat, f, r, _ = countgraph_cases.nbr_inputs("k20-T4-graph",
                                                          "cpu")
    f, r = f[:300], r[:300]
    nf, nr = K.neighbor_kmers(f, r, k)
    canon = umin(nf, nr).reshape(-1).numpy().view(np.uint64).tolist()
    table = flat.numpy()
    offs = K.byte_offsets(primes)
    every, loaded, loads = set(), set(), 0
    for c in canon:
        idx = [offs[t] + c % p for t, p in enumerate(primes)]
        every.update(i >> 5 for i in idx)
        loaded.add(idx[0] >> 5)
        loads += 1
        if table[idx[0]] > 0:
            for i in idx[1:]:
                loaded.add(i >> 5)
                loads += 1
    assert countgraph_cases.byte_probe_floors(primes, flat, f, r, k) == (
        len(every), len(loaded), loads)
