"""The port's perimeter sweep and consume_partitioned_fasta
(khmer_tpu_torch) against the JAX package on the CPU: sweep_for_tags (the
C++ level walk, csrc/sweep_walk.cc, with kernel L's or N's plain version)
and its plain queue walk against JAX's sweep_for_tags under both engines
(KHMER_TPU_ENGINE=auto, the native host sweep; =device, the Python queue)
on a Nodegraph and a Countgraph, at ranges 0, 40 and 81, with stop tags
and without, and with and without the cut of big sweeps; and
consume_partitioned_fasta (its tags, partition map, counts and tables, the
missing-tab error and the atoi parse of the id) against JAX's.

Tolerance: exact everywhere (integer state)."""

import os

import numpy as np
import pytest
import torch

from khmer_tpu import Countgraph as JaxCountgraph
from khmer_tpu import Nodegraph as JaxNodegraph
from khmer_tpu.core import partition as JP
from khmer_tpu_torch.core import partition as P
from khmer_tpu_torch.core.sketch import Countgraph, Nodegraph
from khmer_tpu_torch.ops import host

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

ENGINES = ["auto", "device"]
K_SIZE = 20
RANGES = [0, 40, 81]


@pytest.fixture(scope="module", autouse=True)
def _two_walk_threads():
    """Two threads a walk pass: the workers share the cores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host, "walk_threads", lambda: 2)
        yield


def _reads(seed, n=250, genome_len=3000, length=100, sub=0.01):
    """Seeded reads of a random genome with substitutions (branches)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, genome_len - length))
        read = genome[s:s + length].copy()
        hit = rng.random(length) < sub
        read[hit] = rng.integers(0, 4, int(hit.sum()))
        out.append("".join("ATCG"[c] for c in read))
    return out


@pytest.fixture(scope="module")
def seqs():
    return _reads(5) + _reads(6, n=60, genome_len=8000)


@pytest.fixture(scope="module")
def graphs(seqs):
    """{kind: (JAX graph, port graph holding its state)}: a Nodegraph and
    a Countgraph tagged at density 10 from the reads, every seventh tag a
    stop tag."""
    out = {}
    for kind, jcls, pcls in (("node", JaxNodegraph, Nodegraph),
                             ("count", JaxCountgraph, Countgraph)):
        os.environ["KHMER_TPU_ENGINE"] = "device"
        try:
            jg = jcls(K_SIZE, 5e4, 4)
            jg._set_tag_density(10)
            for s in seqs:
                jg.consume_and_tag(s)
        finally:
            del os.environ["KHMER_TPU_ENGINE"]
        for t in sorted(jg.all_tags)[::7]:
            jg.add_stop_tag(int(t))
        pg = pcls.from_numpy_state(
            K_SIZE, jg._primes, [np.asarray(t) for t in jg.tables],
            int(jg.n_unique_kmers()), 0, device="cpu",
            all_tags=jg.all_tags, stop_tags=jg.stop_tags,
            tag_density=jg._tag_density)
        out[kind] = (jg, pg)
    return out


def _queries(seqs):
    """Sweep queries: reads, a read's half, one k-mer, a sequence shorter
    than k, and a read of another genome."""
    return (seqs[:20] + [seqs[3][:50], seqs[4][:K_SIZE], seqs[5][:10]]
            + _reads(99, n=2))


@pytest.mark.parametrize("kind", ["node", "count"])
@pytest.mark.parametrize("sweep_range", RANGES)
@pytest.mark.parametrize("brake,stop_big", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_sweep_matches_jax(kind, sweep_range, brake, stop_big, graphs,
                           seqs):
    """Each query's (tags, nodes counted): the batched C++ sweep and the
    plain queue walk against JAX's sweep_for_tags under both engines."""
    jg, pg = graphs[kind]
    queries = _queries(seqs)
    found, totals = P.sweep_for_tags_batch(pg, queries, sweep_range, brake,
                                           stop_big)
    got = [(set(f.tolist()), int(n)) for f, n in zip(found, totals)]
    plain = [P.sweep_for_tags_plain(pg, q, sweep_range, brake, stop_big)
             for q in queries]
    assert got == plain
    for engine in ENGINES:
        os.environ["KHMER_TPU_ENGINE"] = engine
        try:
            want = [JP.sweep_for_tags(jg, q, sweep_range, brake, stop_big)
                    for q in queries]
        finally:
            del os.environ["KHMER_TPU_ENGINE"]
        assert got == [(set(int(t) for t in w), int(n)) for w, n in want]
    assert any(g[0] for g in got) or stop_big


@pytest.mark.parametrize("kind", ["node", "count"])
def test_sweep_tag_neighborhood_matches_jax(kind, graphs, seqs):
    """The graph method, one query at a time, at the labels' default
    radius (81)."""
    jg, pg = graphs[kind]
    for q in _queries(seqs)[:8]:
        assert (pg.sweep_tag_neighborhood(q, 81)
                == set(int(t) for t in jg.sweep_tag_neighborhood(q, 81)))


def test_sweep_limit_tested_after_the_last_expansion():
    """A sweep whose traversed nodes pass the limit at its last expanded
    node, which leaves the queue empty: a query of two k-mers (limit
    200 * 1) at the start of a linear path of 201 k-mers, its first k-mer
    a tag. JAX's native engine tests the limit after every expansion and
    gives no tags; its Python engine tests it only while the queue holds
    entries and gives the tag. The port, and its plain queue walk, follow
    the native engine (ROADMAP section 3 logs the difference)."""
    rng = np.random.default_rng(12)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 200 + K_SIZE))
    os.environ["KHMER_TPU_ENGINE"] = "device"
    try:
        jg = JaxNodegraph(K_SIZE, 1e6, 4)
        jg.consume(genome)
    finally:
        del os.environ["KHMER_TPU_ENGINE"]
    jg.add_tag(genome[:K_SIZE])
    pg = Nodegraph.from_numpy_state(
        K_SIZE, jg._primes, [np.asarray(t) for t in jg.tables],
        int(jg.n_unique_kmers()), 0, device="cpu", all_tags=jg.all_tags)
    query = genome[:K_SIZE + 1]
    got = P.sweep_for_tags(pg, query, 250, False, True)
    assert got == P.sweep_for_tags_plain(pg, query, 250, False, True)
    want = {}
    for engine in ENGINES:
        os.environ["KHMER_TPU_ENGINE"] = engine
        try:
            tags, total = JP.sweep_for_tags(jg, query, 250, False, True)
        finally:
            del os.environ["KHMER_TPU_ENGINE"]
        want[engine] = (set(int(t) for t in tags), int(total))
    assert got == want["auto"] == (set(), 201)
    assert want["device"] == ({pg.hash(genome[:K_SIZE])}, 201)


@pytest.mark.parametrize("band", [(1, 5), (2, 5), (0, 0), (0, 1)])
def test_nodegraph_abundance_partition_matches_jax(band, graphs, tmp_path):
    """do_subset_partition_with_abundance on a Nodegraph, whose present
    k-mers count 1 (kernel L's byte is the band's where the band holds 1,
    else nothing is in it): .pmap bytes against JAX's native engine
    cutting big traversals, and its level walk without the cut."""
    jg, pg = graphs["node"]
    for engine, stop_big in (("auto", True), ("device", False)):
        mine = pg.do_subset_partition_with_abundance(
            band[0], band[1], stop_big_traversals=stop_big)
        os.environ["KHMER_TPU_ENGINE"] = engine
        try:
            theirs = jg.do_subset_partition_with_abundance(
                band[0], band[1], stop_big_traversals=stop_big)
        finally:
            del os.environ["KHMER_TPU_ENGINE"]
        mine.save_partitionmap(str(tmp_path / "p.pmap"))
        theirs.save_partitionmap(str(tmp_path / "j.pmap"))
        assert ((tmp_path / "p.pmap").read_bytes()
                == (tmp_path / "j.pmap").read_bytes())


# -- consume_partitioned_fasta ---------------------------------------------


@pytest.fixture(scope="module")
def part_file(tmp_path_factory, seqs):
    """A partitioned FASTA: ids with suffixes that C atoi reads as their
    leading integer ("35abc", " 7 x", "x9"), reads shorter than k, and a
    read repeated (so its first k-mer's partition is set twice)."""
    path = tmp_path_factory.mktemp("part") / "reads.part"
    ids = ["3", "35abc", " 7 x", "0", "12", "x9", "+9", "4"]
    with open(path, "w") as f:
        for i, s in enumerate(seqs[:120] + [seqs[0], "ACGTAC"]):
            f.write(">r%d\t%s\n%s\n" % (i, ids[i % len(ids)], s))
    return str(path)


@pytest.mark.parametrize("kind", ["node", "count"])
@pytest.mark.parametrize("source", ["path", "records"])
def test_consume_partitioned_fasta_matches_jax(kind, source, part_file,
                                               tmp_path):
    """(total reads, k-mers consumed), tags, the partition map's .pmap
    bytes, n_unique and tables against JAX's consume_partitioned_fasta."""
    from khmer_tpu_torch.io.fastx import FastxParser

    jcls, pcls = {"node": (JaxNodegraph, Nodegraph),
                  "count": (JaxCountgraph, Countgraph)}[kind]
    os.environ["KHMER_TPU_ENGINE"] = "device"
    try:
        jg = jcls(K_SIZE, 5e4, 4)
        want = jg.consume_partitioned_fasta(part_file)
    finally:
        del os.environ["KHMER_TPU_ENGINE"]
    pg = pcls(K_SIZE, 5e4, 4, device="cpu")
    got = pg.consume_partitioned_fasta(
        part_file if source == "path" else list(FastxParser(part_file)))
    assert got == tuple(int(v) for v in want)
    assert pg.all_tags == set(int(t) for t in jg.all_tags)
    pg.save_partitionmap(str(tmp_path / "p.pmap"))
    jg.save_partitionmap(str(tmp_path / "j.pmap"))
    assert ((tmp_path / "p.pmap").read_bytes()
            == (tmp_path / "j.pmap").read_bytes())
    assert pg.partition.next_partition_id == jg.partition.next_partition_id
    assert pg.n_unique_kmers() == int(jg.n_unique_kmers())
    for a, b in zip(pg.get_raw_tables(), jg.get_raw_tables()):
        assert np.array_equal(a, np.asarray(b))


def test_consume_partitioned_fasta_needs_the_tab(tmp_path):
    path = tmp_path / "bad.fa"
    path.write_text(">r0\t3\nACGTACGTACGTACGTACGTACGT\n"
                    ">r1 no tab\nACGTACGTACGTACGTACGTAAAA\n")
    pg = Countgraph(K_SIZE, 1e4, 2, device="cpu")
    with pytest.raises(ValueError, match="partition ID for read r1"):
        pg.consume_partitioned_fasta(str(path))


@pytest.mark.parametrize("text,want", [("35", 35), ("35abc", 35),
                                       (" 7 x", 7), ("-2", -2), ("+4", 4),
                                       ("x9", 0), ("", 0)])
def test_atoi_prefix_matches_jax(text, want):
    assert P._atoi_prefix(text) == JP._atoi_prefix(text) == want
