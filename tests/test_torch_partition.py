"""Kernel L's plain version, the C++ partition walk and its numpy copy,
the partition map and the port's own host C++ (khmer_tpu_torch) against
the JAX package, exactly, on the CPU: the 8-neighbour probe and the bit
gather against make_neighbors_fn and _gather_counts("bit"); the walk
against JAX's find_all_tags_batch under both engines
(KHMER_TPU_ENGINE=device, the level walk; =auto, the native host BFS) on
graphs loaded from the same state; SubsetPartition's ids, counts, .pmap
bytes, merges and annotation; the stamps reads against the reference's
golden partition map; and the copied parser and hasher, which the port
builds itself."""

import gzip
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu import Nodegraph as JaxNodegraph
from khmer_tpu.core import graphmixin as JG
from khmer_tpu.core import hostengine as jax_hostengine
from khmer_tpu.core import oxli_io as jax_oxli
from khmer_tpu.core import partition as JP
from khmer_tpu.core import sketch_kernels as JK
from khmer_tpu.io import native as jax_native
from khmer_tpu.ops import hashing as JH
from khmer_tpu_torch.core import hostengine, oxli_io
from khmer_tpu_torch.core import partition as P
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.sketch import Nodegraph
from khmer_tpu_torch.io import native
from khmer_tpu_torch.ops import host

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = os.path.join(REPO, "data", "stamps-reads.fa.gz")
GOLDEN = os.path.join(REPO, "tests", "golden", "stamps_ref_pmap.txt.gz")
ENGINES = ["device", "auto"]


@pytest.fixture(scope="module", autouse=True)
def _two_walk_threads():
    """Two threads a walk pass: the workers share the cores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host, "walk_threads", lambda: 2)
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64)
                            .view(np.int64).copy())


def _reads(n, length, seed, genome_len=3000, sub=0.01):
    """Seeded reads of a random genome with substitutions."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, genome_len - length))
        r = genome[s:s + length].copy()
        hit = rng.random(length) < sub
        r[hit] = rng.integers(0, 4, int(hit.sum()))
        out.append("".join("ATCG"[c] for c in r))
    return out


def _jax_graph(monkeypatch, engine, k, x, seqs, density):
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    g = JaxNodegraph(k, x, 4)
    g._set_tag_density(density)
    for s in seqs:
        g.consume_and_tag(s)
    return g


def _port_graph(jg):
    """The port's Nodegraph on the CPU holding a JAX Nodegraph's state."""
    return Nodegraph.from_numpy_state(
        jg.ksize(), jg._primes, [np.asarray(t) for t in jg.tables], 0, 0,
        device="cpu", all_tags=jg.all_tags, stop_tags=jg.stop_tags,
        tag_density=jg._tag_density)


def _starts(tags, k):
    out = []
    for t in tags:
        _, f, r = JH._hash_scalar(JH.reverse_hash(int(t), k), k)
        out.append((f, r))
    return out


# -- kernel L's plain version ---------------------------------------------


def _random_tables(rng, primes):
    """A joined bit buffer about 40% set, and JAX's per-table views."""
    size = K.bit_flat_size(primes)
    flat = (rng.integers(0, 256, size, dtype=np.uint8)
            & rng.integers(0, 256, size, dtype=np.uint8)
            | (rng.integers(0, 256, size, dtype=np.uint8)
               & rng.integers(0, 256, size, dtype=np.uint8)
               & rng.integers(0, 256, size, dtype=np.uint8)))
    views = tuple(jnp.asarray(flat[o:o + K.bit_table_bytes(p)])
                  for o, p in zip(K.bit_offsets(primes), primes))
    return flat, views


@pytest.mark.parametrize("ntables", [1, 4])
@pytest.mark.parametrize("k", [1, 15, 20, 32])
def test_neighbors_plain_matches_jax(k, ntables):
    """(nf, nr, ncanon, present) of nodes with f of every range (and >=
    2^63 at k 32), the port rebuilding nf and nr from (f, r) and its
    presence from neighbors_plain's byte."""
    rng = np.random.default_rng(100 * k + ntables)
    primes = tuple(K.get_n_primes_near_x(ntables, 9000))
    flat, views = _random_tables(rng, primes)
    n = 400
    top = 4 ** k
    f = np.array([int(v) % top for v in
                  rng.integers(0, 2**64, n, dtype=np.uint64)], np.uint64)
    r = P.revcomp_bits(f, k)
    nf, nr, nc, present = [np.asarray(a) for a in JG.make_neighbors_fn(
        "bit", primes, k)(views, jnp.asarray(f), jnp.asarray(r))]
    pnf, pnr = K.neighbor_kmers(_t(f), _t(r), k)
    assert (pnf.numpy().view(np.uint64) == nf).all()
    assert (pnr.numpy().view(np.uint64) == nr).all()
    masks = K.neighbors_plain(primes, torch.from_numpy(flat), _t(f), _t(r),
                              k).numpy()
    bits = ((masks[:, None] >> np.arange(8)) & 1).astype(bool)
    assert (bits == present).all()
    assert 0 < present.mean() < 1 or k == 1
    got = K.bit_gather_plain(primes, torch.from_numpy(flat), _t(nc)).numpy()
    want = np.asarray(JK._gather_counts("bit", primes, views,
                                        jnp.asarray(nc)))
    assert got.dtype == np.int32 and (got == want).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_nodegraph_neighbors_match_jax(engine, monkeypatch):
    """neighbors_batch, neighbors, kmer_degree and get_counts_for_hashes
    (the bit gather) of a consumed graph, through the Nodegraph API."""
    seqs = _reads(60, 80, 3)
    jg = _jax_graph(monkeypatch, engine, 17, 5e3, seqs, 40)
    pg = _port_graph(jg)
    hashes = np.concatenate([pg._hashes_for_sequence(s) for s in seqs[:5]])
    fs = np.array([JH._hash_scalar(JH.reverse_hash(int(h), 17), 17)[1]
                   for h in hashes], np.uint64)
    rs = P.revcomp_bits(fs, 17)
    want = [np.asarray(a) for a in jg.neighbors_batch(fs, rs)]
    got = pg.neighbors_batch(fs, rs)
    for a, b in zip(got, want):
        assert (a == b).all()
    for h in hashes[:20]:
        assert pg.neighbors(int(h)) == jg.neighbors(int(h))
        kmer = JH.reverse_hash(int(h), 17)
        assert pg.kmer_degree(kmer) == jg.kmer_degree(kmer)
    probe = np.concatenate([hashes, hashes + np.uint64(1)])
    assert (pg.get_counts_for_hashes(probe)
            == jg.get_counts_for_hashes(probe)).all()


# -- the walk ---------------------------------------------------------------


@pytest.fixture(scope="module")
def walk_seqs():
    """Reads of two genomes: one covered deeply (one component with error
    branches), one thinly (several components)."""
    return _reads(200, 100, 5) + _reads(100, 100, 6, genome_len=6000)


def _jax_walk(jg, starts, brake, stop_big, monkeypatch, engine):
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    return [set(w) for w in JP.find_all_tags_batch(jg, starts, brake,
                                                   stop_big)]


@pytest.mark.parametrize("stop_big", [False, True])
@pytest.mark.parametrize("density", [2, 10, 40])
def test_walk_matches_jax(density, stop_big, walk_seqs, monkeypatch):
    """The tags every traversal from every tag finds: the C++ walk (with
    kernel L's plain version) and its plain reference against JAX's
    find_all_tags_batch under both engines, with every seventh tag a stop
    tag, braking on them and not. The port walks by the reference's queue
    rule, as JAX's native engine (=auto) does, and equals it everywhere.
    JAX's level walk (=device) also cuts a big traversal when a level
    holds only nodes kept since they were queued: where the two JAX
    engines differ (the level walk cut a traversal that the queue walk
    let finish), the port differs from the level walk alike, and nowhere
    else."""
    jg = _jax_graph(monkeypatch, "device", 15, 2e4, walk_seqs, density)
    for t in sorted(jg.all_tags)[::7]:
        jg.add_stop_tag(int(t))
    pg = _port_graph(jg)
    tags = np.array(sorted(jg.all_tags), np.uint64)
    starts = _starts(tags, 15)
    assert [f for f, _ in starts] == tags.tolist()
    for brake in (True, False):
        level = _jax_walk(jg, starts, brake, stop_big, monkeypatch,
                          "device")
        native = _jax_walk(jg, starts, brake, stop_big, monkeypatch, "auto")
        got = P.find_all_tags_batch(pg, tags, P.revcomp_bits(tags, 15),
                                    brake, stop_big)
        got = [set(a.tolist()) for a in got]
        assert got == native
        assert P.find_all_tags_plain(pg, starts, brake, stop_big) == native
        assert sum(len(w) for w in native) > 0
        engines_differ = [i for i in range(len(tags))
                          if level[i] != native[i]]
        assert [i for i in range(len(tags))
                if got[i] != level[i]] == engines_differ
        assert stop_big or not engines_differ
        assert all(not level[i] and native[i] for i in engines_differ)


def test_walk_where_jax_engines_differ(monkeypatch):
    """On 300 reads of one genome at tag density 40, cutting traversals at
    200 nodes and not braking on stop tags, JAX's level walk cuts a
    traversal on which its native queue walk finds tags; the port finds
    them as the queue walk (and the reference) does."""
    jg = _jax_graph(monkeypatch, "device", 15, 2e4, _reads(300, 100, 5),
                    40)
    for t in sorted(jg.all_tags)[::7]:
        jg.add_stop_tag(int(t))
    pg = _port_graph(jg)
    tags = np.array(sorted(jg.all_tags), np.uint64)
    starts = _starts(tags, 15)
    level = _jax_walk(jg, starts, False, True, monkeypatch, "device")
    native = _jax_walk(jg, starts, False, True, monkeypatch, "auto")
    got = P.find_all_tags_batch(pg, tags, P.revcomp_bits(tags, 15), False,
                                True)
    differ = [i for i in range(len(tags)) if level[i] != native[i]]
    assert differ
    assert [set(a.tolist()) for a in got] == native
    assert all(got[i].size and not level[i] for i in differ)


def test_walk_cuts_big_traversals(walk_seqs, monkeypatch):
    """At tag density 40 some traversals pass 200 nodes: cut, they find no
    tags, where the full walk finds some; the C++ walk cuts the same
    ones."""
    jg = _jax_graph(monkeypatch, "auto", 15, 2e4, walk_seqs, 40)
    pg = _port_graph(jg)
    tags = np.array(sorted(jg.all_tags), np.uint64)
    rc = P.revcomp_bits(tags, 15)
    full = P.find_all_tags_batch(pg, tags, rc, False, False)
    cut = P.find_all_tags_batch(pg, tags, rc, False, True)
    want = _jax_walk(jg, _starts(tags, 15), False, True, monkeypatch,
                     "auto")
    assert [set(a.tolist()) for a in cut] == [set(w) for w in want]
    emptied = [i for i in range(len(tags)) if len(full[i]) and not
               len(cut[i])]
    assert emptied
    for i in emptied[:3] + [0, len(tags) - 1]:
        f, r = _starts([tags[i]], 15)[0]
        assert P.find_all_tags(pg, f, r, False, True) == want[i]
        assert P.find_all_tags(pg, f, r) == set(full[i].tolist())


def test_walk_batch_and_threads_change_nothing(walk_seqs, monkeypatch):
    """do_partition in slices of 7 start tags, and the walk on one thread,
    give the same ids as one batch."""
    jg = _jax_graph(monkeypatch, "device", 15, 2e4, walk_seqs, 10)
    pg = _port_graph(jg)
    one = P.SubsetPartition(pg)
    one.do_partition(stop_big_traversals=True)
    sliced = P.SubsetPartition(pg)
    with monkeypatch.context() as m:
        m.setattr(P, "WALK_BATCH", 7)
        sliced.do_partition(stop_big_traversals=True)
    monkeypatch.setattr(host, "walk_threads", lambda: 1)
    serial = P.SubsetPartition(pg)
    serial.do_partition(stop_big_traversals=True)
    ids = [{t: s.get_partition_id(t) for t in pg.all_tags}
           for s in (one, sliced, serial)]
    assert ids[0] == ids[1] == ids[2]


@pytest.mark.parametrize("budget", [10_000, 1 << 30])
def test_walk_batches_follow_the_keeper_budget(budget, walk_seqs,
                                               monkeypatch):
    """The walk's first batch takes FIRST_BATCH start tags and each later
    one as many as KEEPER_BYTES holds at the keeper bytes a traversal of
    the batch before it reached (at least 1, at most WALK_BATCH); a keeper
    takes 12 B a slot, at least 64 slots; the tags found do not change."""
    jg = _jax_graph(monkeypatch, "device", 15, 2e4, walk_seqs, 10)
    pg = _port_graph(jg)
    tags = np.array(sorted(jg.all_tags), np.uint64)
    rc = P.revcomp_bits(tags, 15)
    want = P.find_all_tags_batch(pg, tags, rc)
    seen = []

    class Recorded(host.TagWalk):
        def keeper_bytes(self):
            held = super().keeper_bytes()
            seen.append((self.n, held))
            return held

    monkeypatch.setattr(host, "TagWalk", Recorded)
    monkeypatch.setattr(P, "FIRST_BATCH", 5)
    monkeypatch.setattr(P, "KEEPER_BYTES", budget)
    monkeypatch.setattr(P, "WALK_BATCH", 50)
    got = P.find_all_tags_batch(pg, tags, rc)
    assert [a.tolist() for a in got] == [a.tolist() for a in want]
    sizes = [n for n, _ in seen]
    assert sizes[0] == 5 and sum(sizes) == len(tags)
    rule = [min(50, max(1, n * budget // held)) for n, held in seen]
    assert sizes[1:-1] == rule[:-2] and sizes[-1] <= rule[-2]
    assert all(held >= 12 * 64 * n for n, held in seen)
    if budget < 1 << 20:
        assert max(rule) < 50  # the budget sizes every batch
    else:
        assert rule == [50] * len(rule)


# -- the partition map --------------------------------------------------------


def _pmap_bytes(subset, path):
    subset.save_partitionmap(str(path))
    return path.read_bytes()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("stop_big", [False, True])
def test_subset_partition_matches_jax(stop_big, engine, walk_seqs,
                                      monkeypatch, tmp_path):
    """Every tag's id, the .pmap bytes before count_partitions and after
    it (its header then counts the null entries), count_partitions,
    partition_sizes and partition_size_distribution."""
    jg = _jax_graph(monkeypatch, engine, 15, 2e4, walk_seqs, 10)
    pg = _port_graph(jg)
    js = JP.SubsetPartition(jg)
    js.do_partition(0, 0, True, stop_big)
    ps = pg.do_subset_partition(0, 0, True, stop_big)
    assert {t: ps.get_partition_id(t) for t in pg.all_tags} == \
        {t: js.get_partition_id(t) for t in jg.all_tags}
    assert _pmap_bytes(ps, tmp_path / "p0") == _pmap_bytes(js,
                                                           tmp_path / "j0")
    assert ps.count_partitions() == js.count_partitions()
    assert _pmap_bytes(ps, tmp_path / "p1") == _pmap_bytes(js,
                                                           tmp_path / "j1")
    assert ps.partition_sizes() == js.partition_sizes()
    assert ps.partition_sizes(3) == js.partition_sizes(3)
    assert (ps.partition_size_distribution()
            == js.partition_size_distribution())
    assert ps.count_partitions()[0] > 1


@pytest.mark.parametrize("order", ["forward", "reverse"])
def test_merge_from_disk_matches_jax(order, walk_seqs, monkeypatch,
                                     tmp_path):
    """Subsets of 60 tags partitioned and saved by JAX, merged from disk
    in either order into the reference's one-byte graph: the ids, the
    merged .pmap bytes, and a merge of the in-memory subsets."""
    jg = _jax_graph(monkeypatch, "auto", 15, 2e4, walk_seqs, 10)
    pg = _port_graph(jg)
    divvy = jg.divide_tags_into_subsets(60)
    assert pg.divide_tags_into_subsets(60) == divvy
    bounds = list(zip(divvy, divvy[1:] + [0]))
    paths = []
    for i, (lo, hi) in enumerate(bounds):
        paths.append(str(tmp_path / ("g.subset.%d.pmap" % i)))
        jg.do_subset_partition(lo, hi, True, True).save_partitionmap(
            paths[-1])
        ps = pg.do_subset_partition(lo, hi, True, True)
        assert _pmap_bytes(ps, tmp_path / "p.pmap") == open(
            paths[-1], "rb").read()
    assert len(paths) > 2
    if order == "reverse":
        paths.reverse()
    jm = JaxNodegraph(15, 1, 1)
    pm = Nodegraph(15, 1, 1, device="cpu")
    for path in paths:
        jm.merge_subset_from_disk(path)
        pm.merge_subset_from_disk(path)
    assert pm.partition.partition_map.keys() == \
        jm.partition.partition_map.keys()
    assert {t: pm.partition.get_partition_id(t)
            for t in pm.partition.partition_map} == \
        {t: jm.partition.get_partition_id(t)
         for t in jm.partition.partition_map}
    jm.save_partitionmap(str(tmp_path / "j.merged"))
    pm.save_partitionmap(str(tmp_path / "p.merged"))
    assert (tmp_path / "p.merged").read_bytes() == \
        (tmp_path / "j.merged").read_bytes()
    jsub = [JP.SubsetPartition.load(p, jg) for p in paths]
    psub = [P.SubsetPartition.load(p, pg) for p in paths]
    for a, b in zip(jsub[1:], psub[1:]):
        jsub[0].merge(a)
        psub[0].merge(b)
    assert {t: psub[0].get_partition_id(t) for t in pg.all_tags} == \
        {t: jsub[0].get_partition_id(t) for t in jg.all_tags}


def test_merge_skips_stop_tags_and_checks_headers(walk_seqs, monkeypatch,
                                                  tmp_path):
    """A merge leaves stop tags out; a .pmap of another k or another type
    raises as JAX's does."""
    jg = _jax_graph(monkeypatch, "auto", 15, 2e4, walk_seqs, 10)
    path = str(tmp_path / "g.pmap")
    jg.do_subset_partition(0, 0, True, True).save_partitionmap(path)
    stops = sorted(jg.all_tags)[::3]
    jm, pm = JaxNodegraph(15, 1, 1), Nodegraph(15, 1, 1, device="cpu")
    for g in (jm, pm):
        for t in stops:
            g.add_stop_tag(int(t))
        g.merge_subset_from_disk(path)
    assert pm.partition.partition_map.keys() == \
        jm.partition.partition_map.keys()
    assert pm.n_stop_tags() == jm.n_stop_tags() == len(stops)
    assert pm.get_stop_tags() == jm.get_stop_tags()
    with pytest.raises(OSError, match="k-mer size 15"):
        Nodegraph(16, 1, 1, device="cpu").merge_subset_from_disk(path)
    tagset = str(tmp_path / "g.tagset")
    jax_oxli.save_tagset(tagset, 15, jg.all_tags, 10)
    with pytest.raises(OSError, match="format type 3"):
        Nodegraph(15, 1, 1, device="cpu").load_partitionmap(tagset)


def test_stop_tags_load_as_jax(walk_seqs, monkeypatch, tmp_path):
    """load_stop_tags of a stoptags file JAX wrote, replacing and adding."""
    jg = _jax_graph(monkeypatch, "auto", 15, 2e4, walk_seqs, 10)
    path = str(tmp_path / "g.stoptags")
    jax_oxli.save_stoptags(path, 15, sorted(jg.all_tags)[::5])
    pg = _port_graph(jg)
    pg.add_stop_tag(12345)
    pg.load_stop_tags(path, clear_tags=False)
    jg.add_stop_tag(12345)
    jg.load_stop_tags(path, clear_tags=False)
    assert pg.stop_tags == jg.stop_tags
    pg.load_stop_tags(path)
    jg.load_stop_tags(path)
    assert pg.stop_tags == jg.stop_tags == oxli_io.load_stoptags(path, 15)
    with pytest.raises(OSError, match="k-mer size"):
        oxli_io.load_stoptags(path, 16)


@pytest.mark.parametrize("engine", ENGINES)
def test_output_partitions_matches_jax(engine, walk_seqs, monkeypatch,
                                       tmp_path):
    """Annotated reads, FASTA and FASTQ, with reads shorter than k, reads
    with no tag and N bases, unassigned reads written and not, before and
    after count_partitions adds its null entries: the bytes and the
    count."""
    jg = _jax_graph(monkeypatch, engine, 15, 2e4, walk_seqs, 10)
    pg = _port_graph(jg)
    js = JP.SubsetPartition(jg)
    js.do_partition(0, 0, True, True)
    ps = pg.do_subset_partition(0, 0, True, True)
    rng = np.random.default_rng(9)
    fa, fq = [], []
    for i, s in enumerate(walk_seqs + _reads(40, 60, 77)):
        if i % 23 == 0:
            s = s[:int(rng.integers(1, 15))]
        if i % 17 == 0:
            s = s[:30] + "N" + s[31:]
        fa.append(">r%d\n%s\n" % (i, s))
        fq.append("@q%d\n%s\n+\n%s\n" % (i, s, "I" * len(s)))
    (tmp_path / "in.fa").write_text("".join(fa))
    (tmp_path / "in.fq").write_text("".join(fq))
    for when in ("before", "after"):
        if when == "after":
            assert ps.count_partitions() == js.count_partitions()
        for name in ("in.fa", "in.fq"):
            for unassigned in (False, True):
                src = str(tmp_path / name)
                n_p = ps.output_partitioned_file(
                    src, str(tmp_path / "p.out"), unassigned)
                n_j = js.output_partitioned_file(
                    src, str(tmp_path / "j.out"), unassigned)
                assert n_p == n_j > 0
                assert (tmp_path / "p.out").read_bytes() == \
                    (tmp_path / "j.out").read_bytes()


def test_stamps_partition_matches_reference_pmap(monkeypatch):
    """The full stamps reads (the tagged consume from JAX's host engine):
    the port's do_partition with stop_big_traversals gives 16,121 tags,
    (51, 16,025) and every tag's id in the reference's golden map."""
    monkeypatch.setenv("KHMER_TPU_ENGINE", "auto")
    jg = JaxNodegraph(20, 12.5e6, 4)
    jg.consume_seqfile_and_tag(STAMPS)
    pg = _port_graph(jg)
    ref = {}
    with gzip.open(GOLDEN, "rt") as f:
        for line in f:
            tag, pid = line.split()
            ref[int(tag)] = int(pid)
    assert sorted(pg.all_tags) == sorted(ref) and len(ref) == 16121
    sp = P.SubsetPartition(pg)
    sp.do_partition(0, 0, stop_big_traversals=True)
    assert sp.count_partitions() == (51, 16025)
    assert [t for t in ref if sp.get_partition_id(t) != ref[t]] == []


# -- the port's own host C++ ------------------------------------------------


@pytest.mark.parametrize("path", ["data/25k.fq.gz", "data/stamps-reads.fa.gz",
                                  "data/stamps-genomes.fa"])
def test_packer_and_hasher_match_jax(path):
    """The copied parser's blocks and the copied dense hasher's hashes
    (per block of reads, and per flat chunk with read starts; the murmur
    family per block) against the JAX package's native library; it has no
    cyclic family."""
    if not jax_native.available() or not jax_hostengine.available():
        pytest.skip("the JAX package's native library is not built")
    path = os.path.join(REPO, path)
    mine = list(native.pack_blocks(path))
    theirs = list(jax_native.pack_blocks(path))
    assert len(mine) == len(theirs)
    for (c, m, b), (jc, jm, jb) in zip(mine, theirs):
        assert (c == jc).all() and (m == jm).all() and b == jb
    codes, meta, _ = mine[0]
    for k in (1, 20, 32):
        got = hostengine.hash_dense_reads(codes, meta[:, 0], meta[:, 1], k,
                                          "twobit")
        want = jax_hostengine.hash_dense_reads(codes, meta[:, 0],
                                               meta[:, 1], k, "twobit")
        assert (got == want).all() and len(got) > 0
        fill = min(len(codes), 1 << 16)
        starts = meta[:, 0][meta[:, 0] < fill].astype(np.int32)
        starts = np.concatenate([starts, np.full(7, 1 << 20, np.int32)])
        got = hostengine.hash_dense(codes, starts, fill, k, "twobit")
        want = jax_hostengine.hash_dense(codes, starts, fill, k, "twobit")
        assert (got == want).all()
    for k in (1, 20, 32):  # the murmur family (the murmur tables)
        got = hostengine.hash_dense_reads(codes, meta[:, 0], meta[:, 1], k,
                                          "murmur")
        want = jax_hostengine.hash_dense_reads(codes, meta[:, 0],
                                               meta[:, 1], k, "murmur")
        assert (got == want).all() and len(got) > 0
    with pytest.raises(NotImplementedError):
        hostengine.hash_dense_reads(codes, meta[:, 0], meta[:, 1], 20,
                                    "cyclic")


def test_port_names_no_jax_library_and_imports_no_jax():
    """No module of the port, and not chip_smoke.py, names the JAX
    package's native sources or libraries or builds them; importing the
    partition and knot modules and CLIs pulls in no JAX."""
    banned = re.compile(r"libkhmer_tpu_(host|io)|hostgraph\.cc|make -C|"
                        r"\"make\"|[\"']src[\"']|(?<![\w/])src/(?!oxli)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "khmer_tpu_torch")):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cc", ".cu", ".cuh", ".h"))]
    found = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if banned.search(line):
                    found.append("%s:%d: %s" % (path, i, line.strip()))
    assert found == []
    code = ("import sys, khmer_tpu_torch.core.partition, "
            "khmer_tpu_torch.cli.do_partition, "
            "khmer_tpu_torch.cli.partition_graph, "
            "khmer_tpu_torch.cli.merge_partitions, "
            "khmer_tpu_torch.cli.annotate_partitions, "
            "khmer_tpu_torch.core.traversal, "
            "khmer_tpu_torch.cli.make_initial_stoptags, "
            "khmer_tpu_torch.cli.find_knots, "
            "khmer_tpu_torch.cli.filter_stoptags, "
            "khmer_tpu_torch.cli.extract_partitions; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'khmer_tpu.')) "
            "or m == 'khmer_tpu' for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"


def test_failed_host_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes build() raise: nothing falls back."""
    monkeypatch.setattr(host, "CXX", "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host.build(str(tmp_path / "lib.so"))
    assert not (tmp_path / "lib.so").exists()
