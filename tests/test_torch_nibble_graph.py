"""A SmallCountgraph as a de Bruijn graph in the port (khmer_tpu_torch)
against the JAX package on the CPU: kernel N's nibble mode (its plain
version) against make_neighbors_fn's nibble kind and, with a band, JAX's
4-bit counts of each neighbour; the tagged consume, the partition with
and without an abundance band (bands below, at and past the saturation
at 15), the abundance walk against its plain queue walk, the perimeter
sweep, find_all_tags, the bounded traversal and the knot pipeline's
excursions and repartition, each against JAX's SmallCountgraph under
both engines (KHMER_TPU_ENGINE=auto, its native engine, which walks
nibble tables too; =device, its level walk), where the two agree (the
cut of big traversals and max_count's order split them, ROADMAP section
3).

Tolerance: exact everywhere (integer state)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu import Countgraph as JaxCountgraph
from khmer_tpu import SmallCountgraph as JaxSmallCountgraph
from khmer_tpu.core import graphmixin as JG
from khmer_tpu.core import partition as JP
from khmer_tpu.core import traversal as JT
from khmer_tpu.ops import hashing as JH
from khmer_tpu_torch.core import partition as P
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core import traversal as T
from khmer_tpu_torch.core.sketch import Countgraph, SmallCountgraph
from khmer_tpu_torch.ops import host
from khmer_tpu_torch.scripts import family_cases

from .test_torch_countgraph_graph import graph_reads
from .test_torch_knots import FREQUENCY, RADIUS, THRESHOLD, lump_reads

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

ENGINES = ["auto", "device"]
K_SIZE = 20
# abundance bands: below the saturation, its top at the saturation, past
# it, and a band of counts past 1
BANDS = [(1, 14), (1, 15), (2, 255), (3, 65535)]


@pytest.fixture(scope="module", autouse=True)
def _two_walk_threads():
    """Two threads a walk pass: the workers share the cores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host, "walk_threads", lambda: 2)
        yield


def _with_engine(engine, fn):
    os.environ["KHMER_TPU_ENGINE"] = engine
    try:
        return fn()
    finally:
        del os.environ["KHMER_TPU_ENGINE"]


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Seeded reads of two genomes (lowercase runs, Ns, short reads, one
    read 300 times: its 4-bit counters saturate)."""
    path = tmp_path_factory.mktemp("nibble-graph") / "reads.fa"
    seqs = graph_reads(7, n=250)
    with open(path, "w") as f:
        for i, seq in enumerate(seqs):
            f.write(">r%d\n%s\n" % (i, seq))
    return str(path), seqs


@pytest.fixture(scope="module")
def jax_graphs(reads):
    """{engine: (JAX SmallCountgraph tagged from the reads, (reads, new
    k-mers))}."""
    def tagged():
        g = JaxSmallCountgraph(K_SIZE, 4e4, 4)
        return g, tuple(int(v) for v in g.consume_seqfile_and_tag(reads[0]))
    return {engine: _with_engine(engine, tagged) for engine in ENGINES}


def _port_graph(jg, stop_tags=None):
    """The port's SmallCountgraph on the CPU holding a JAX one's state."""
    return SmallCountgraph.from_numpy_state(
        jg.ksize(), jg._primes, [np.asarray(t) for t in jg.tables],
        int(jg.n_unique_kmers()), 0, device="cpu", all_tags=jg.all_tags,
        stop_tags=jg.stop_tags if stop_tags is None else stop_tags,
        tag_density=jg._tag_density)


# -- kernel N's nibble mode (its plain version) -------------------------------


@pytest.mark.parametrize("name", list(family_cases.NIBBLE_NBR_CASES))
def test_nibble_neighbors_plain_matches_jax(name):
    """The presence byte of N's nibble mode against JAX's
    make_neighbors_fn, nibble kind, on the kernel's cases (odd primes,
    whose neighbours share a byte's two nibbles, among them), and the band
    bytes against JAX's 4-bit counts of each neighbour."""
    primes, k, flat, f, r = family_cases.nibble_nbr_inputs(name, "cpu")
    views = tuple(jnp.asarray(t.numpy())
                  for t in K.NibbleTables(flat, primes))
    fu, ru = (x.numpy().view(np.uint64) for x in (f, r))
    _, _, nc, present = (np.asarray(a) for a in JG.make_neighbors_fn(
        "nibble", primes, k)(views, jnp.asarray(fu), jnp.asarray(ru)))
    bits = lambda m: ((m.numpy()[:, None] >> np.arange(8)) & 1).astype(bool)
    assert (bits(K.nibble_neighbors_plain(primes, flat, f, r, k))
            == present).all()
    counts = np.asarray(JG.K._gather_counts("nibble", primes, views,
                                            jnp.asarray(nc.ravel()))
                        ).reshape(nc.shape)
    for band in family_cases.NIBBLE_BANDS:
        pres, got = K.nibble_neighbors_plain(primes, flat, f, r, k, band)
        assert (bits(pres) == present).all()
        assert (bits(got) == ((counts >= max(band[0], 1))
                              & (counts <= band[1]))).all()


def test_odd_primes_put_neighbours_in_both_nibbles():
    """The odd-primes case does what its name says: some node has two
    neighbours whose counters are the two nibbles of one byte."""
    primes, k, flat, f, r = family_cases.nibble_nbr_inputs("k20-odd-primes",
                                                           "cpu")
    nf, nr = K.neighbor_kmers(f, r, k)
    canon = K.umin(nf, nr)
    bins = K.umod(canon, primes[0])
    byte, nib = bins >> 1, bins & 1
    both = ((byte[:, :, None] == byte[:, None, :])
            & (nib[:, :, None] != nib[:, None, :])).any(2).any(1)
    assert both.any()


# -- the graph ---------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_tagged_consume_matches_jax(engine, reads, jax_graphs, tmp_path):
    """Tags, (reads, new k-mers), n_unique, the type-7 file and the
    .tagset of the port's tagged consume against JAX's."""
    jg, jgot = jax_graphs[engine]
    pg = SmallCountgraph(K_SIZE, 4e4, 4, device="cpu")
    assert pg.consume_seqfile_and_tag(reads[0]) == jgot
    assert pg.all_tags == set(int(t) for t in jg.all_tags)
    assert pg.n_unique_kmers() == int(jg.n_unique_kmers())
    for name, save in (("g.ct", "save"), ("g.tagset", "save_tagset")):
        getattr(pg, save)(str(tmp_path / ("p" + name)))
        getattr(jg, save)(str(tmp_path / ("j" + name)))
        assert ((tmp_path / ("p" + name)).read_bytes()
                == (tmp_path / ("j" + name)).read_bytes())
    assert pg.n_tags() > 10


def test_neighbour_methods_match_jax(reads, jax_graphs):
    """neighbors, kmer_degree and find_high_degree_nodes."""
    jg, _ = jax_graphs["auto"]
    pg = _port_graph(jg)
    for seq in reads[1][:40]:
        if len(seq) < K_SIZE:
            continue
        kmer = seq[:K_SIZE]
        assert sorted(pg.neighbors(kmer)) == sorted(
            int(v) for v in jg.neighbors(kmer))
        assert pg.kmer_degree(kmer) == jg.kmer_degree(kmer)
        assert pg.find_high_degree_nodes(seq) == set(
            int(v) for v in jg.find_high_degree_nodes(seq))


def _pmap_bytes(subset, path):
    subset.save_partitionmap(str(path))
    return path.read_bytes()


@pytest.mark.parametrize("band", [None] + BANDS)
@pytest.mark.parametrize("stop_big", [False, True])
def test_partition_matches_jax(band, stop_big, jax_graphs, tmp_path):
    """do_subset_partition and do_subset_partition_with_abundance: .pmap
    bytes and counts against JAX's native engine, and against its level
    walk where the two engines agree (no cut of big traversals)."""
    for engine, (jg, _) in jax_graphs.items():
        if engine == "device" and stop_big:
            continue

        def both():
            pg = _port_graph(jg)
            if band is None:
                return (jg.do_subset_partition(0, 0, False, stop_big),
                        pg.do_subset_partition(0, 0, False, stop_big))
            return (jg.do_subset_partition_with_abundance(
                band[0], band[1], stop_big_traversals=stop_big),
                pg.do_subset_partition_with_abundance(
                    band[0], band[1], stop_big_traversals=stop_big))
        js, ps = _with_engine(engine, both)
        assert (_pmap_bytes(ps, tmp_path / "p.pmap")
                == _pmap_bytes(js, tmp_path / "j.pmap"))
        assert ps.count_partitions() == js.count_partitions()


def test_bands_at_the_saturation_differ(jax_graphs):
    """On the saturated graph, a band whose top is 14 drops the k-mers at
    15 that a band whose top is 15 keeps: their partitions differ."""
    jg, _ = jax_graphs["auto"]
    pg = _port_graph(jg)
    low = pg.do_subset_partition_with_abundance(1, 14).count_partitions()
    top = pg.do_subset_partition_with_abundance(1, 15).count_partitions()
    assert low != top
    assert top == pg.do_subset_partition(0, 0).count_partitions()


@pytest.mark.parametrize("band", BANDS + [(0, 0)])
def test_abundance_walk_matches_plain(band, jax_graphs):
    """The C++ walk with N's nibble band against find_all_tags_plain's
    queue walk, from every tag, every fifth tag a stop tag."""
    jg, _ = jax_graphs["auto"]
    pg = _port_graph(jg)
    tags = np.array(sorted(pg.all_tags), np.uint64)
    pg.stop_tags = set(int(t) for t in tags[::5])
    r = P.revcomp_bits(tags, K_SIZE)
    got = P.find_all_tags_batch(pg, tags, r, True, True, count_range=band)
    want = P.find_all_tags_plain(pg, list(zip(tags.tolist(), r.tolist())),
                                 True, True, count_range=band)
    assert [set(g.tolist()) for g in got] == want
    assert sum(map(len, want)) > 0 or band == (0, 0)


def test_find_all_tags_matches_jax(jax_graphs):
    """find_all_tags_list from tags, against JAX's under both engines."""
    for engine, (jg, _) in jax_graphs.items():
        pg = _port_graph(jg)
        for tag in sorted(pg.all_tags)[:60:6]:
            kmer = JH.reverse_hash(int(tag), K_SIZE)
            want = _with_engine(engine, lambda: jg.find_all_tags_list(kmer))
            assert sorted(pg.find_all_tags_list(kmer)) == sorted(
                int(t) for t in want)


@pytest.mark.parametrize("sweep_range", [0, 40, 81])
def test_sweep_matches_jax(sweep_range, reads, jax_graphs):
    """Each query's (tags, nodes counted): the batched C++ sweep and the
    plain queue walk against JAX's sweep_for_tags under both engines,
    with every seventh tag a stop tag."""
    seqs = reads[1][:25] + [reads[1][3][:50], reads[1][4][:K_SIZE]]
    for engine, (jg, _) in jax_graphs.items():
        stops = set(sorted(jg.all_tags)[::7])
        jg.stop_tags = set(stops)
        try:
            pg = _port_graph(jg)
            found, totals = P.sweep_for_tags_batch(pg, seqs, sweep_range,
                                                   True, False)
            got = [(set(f.tolist()), int(n)) for f, n in zip(found, totals)]
            assert got == [P.sweep_for_tags_plain(pg, q, sweep_range, True,
                                                  False) for q in seqs]
            want = _with_engine(engine, lambda: [
                JP.sweep_for_tags(jg, q, sweep_range, True, False)
                for q in seqs])
        finally:
            jg.stop_tags = set()
        assert got == [(set(int(t) for t in w), int(n)) for w, n in want]
        assert any(g[0] for g in got)


# -- the knot pipeline's excursions ----------------------------------------


@pytest.fixture(scope="module")
def lump():
    """A lump with knots (two genomes sharing repeats) as a JAX
    SmallCountgraph, tagged under its native engine."""
    seqs = lump_reads(29, n_genomes=2, genome_len=2000, n_reads=700)

    def tagged():
        g = JaxSmallCountgraph(K_SIZE, 2e5, 4)
        for s in seqs:
            g.consume_and_tag(s)
        return g
    return seqs, _with_engine("auto", tagged)


@pytest.mark.parametrize("engine", ENGINES)
def test_traversal_matches_jax(engine, lump):
    """traverse_from_kmer and bfs from tags at radii 0, 1, 7 and 40 (no
    max_count, where the engines agree), with every fifth tag a stop tag,
    against JAX's; and the batched excursion walk's counts."""
    seqs, jg = lump
    tags = sorted(jg.all_tags)
    jg.stop_tags = set(tags[::5])
    try:
        pg = _port_graph(jg)
        starts = tags[1:200:19] + [seqs[3][10:10 + K_SIZE]]
        for kmer in starts:
            for radius in (0, 1, 7, 40):
                keeper = set()
                want = _with_engine(engine, lambda: JT.traverse_from_kmer(
                    jg, kmer, radius, keeper=keeper))
                got = set()
                assert T.traverse_from_kmer(pg, kmer, radius,
                                            keeper=got) == want
                assert got == keeper
                f, r = T._start(pg, kmer)
                assert T.bfs(pg, f, r, radius=radius) == (want, keeper)
    finally:
        jg.stop_tags = set()
    ends = np.array(tags[:150], np.uint64)
    walk = T.walk_excursions(pg, ends, P.revcomp_bits(ends, K_SIZE), RADIUS)
    try:
        counts = walk.counts()
    finally:
        walk.close()
    assert counts.tolist() == [T.traverse_from_kmer(pg, int(t), RADIUS)
                               for t in ends]


@pytest.mark.parametrize("counting", ["byte", "nibble"])
def test_repartition_matches_jax(counting, lump, tmp_path):
    """repartition_largest_partition on the SmallCountgraph (its
    excursions probed by N's nibble mode) with a byte or nibble counting
    table: stop tags, small tags, partition ids, .pmap bytes, counting
    tables and the returned size, against JAX's native engine."""
    _, jg = lump
    jcls, pcls = {"byte": (JaxCountgraph, Countgraph),
                  "nibble": (JaxSmallCountgraph, SmallCountgraph)}[counting]
    pg = _port_graph(jg, set())

    def jax_side():
        jg.stop_tags = set()
        subset = jg.do_subset_partition(0, 0)
        table = jcls(32, 3e4, 4)
        size = jg.repartition_largest_partition(table, RADIUS, THRESHOLD,
                                                FREQUENCY, subs=subset)
        return subset, table, size
    jsub, jtable, jsize = _with_engine("auto", jax_side)
    want = (jsize, set(jg.stop_tags), set(jg.repart_small_tags),
            {int(t): jsub.get_partition_id(t) for t in jg.all_tags},
            [np.asarray(t).tobytes() for t in jtable.tables],
            _pmap_bytes(jsub, tmp_path / "j.pmap"))
    jg.stop_tags = set()
    del jg.repart_small_tags
    psub = pg.do_subset_partition(0, 0)
    ptable = pcls(32, 3e4, 4, device="cpu")
    psize = pg.repartition_largest_partition(ptable, RADIUS, THRESHOLD,
                                             FREQUENCY, subs=psub)
    got = (psize, set(pg.stop_tags), set(pg.repart_small_tags),
           {int(t): psub.get_partition_id(t) for t in pg.all_tags},
           [np.asarray(t).tobytes() for t in ptable.tables],
           _pmap_bytes(psub, tmp_path / "p.pmap"))
    assert got == want
    assert got[1] and len(set(got[3].values())) > 1
