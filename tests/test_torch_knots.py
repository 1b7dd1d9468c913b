"""The knot pipeline's parts in the port (khmer_tpu_torch) against the JAX
package, exactly, on the CPU: the stop-tag file writer, the bounded-radius
traversal (the batched excursion walk and its plain reference) against
JAX's traverse_from_kmer under both engines (KHMER_TPU_ENGINE=device, its
level BFS; =auto, the native host BFS), kernel M's plain version against
make_pertable_get, and repartition_largest_partition against JAX's under
its native engine at several batch sizes, on a lump with real knots:
reads of four genomes that share repeats."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu import Countgraph as JaxCountgraph
from khmer_tpu import Nodegraph as JaxNodegraph
from khmer_tpu.core import oxli_io as jax_oxli
from khmer_tpu.core import sketch_kernels as JK
from khmer_tpu.core import traversal as JT
from khmer_tpu_torch.core import oxli_io
from khmer_tpu_torch.core import partition as P
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core import traversal as T
from khmer_tpu_torch.core.sketch import Countgraph, Nodegraph
from khmer_tpu_torch.ops import host

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_SIZE = 20
# the CLIs' excursion constants (find-knots, make-initial-stoptags)
RADIUS, THRESHOLD, FREQUENCY = 40, 200, 5


@pytest.fixture(scope="module", autouse=True)
def _two_walk_threads():
    """Two threads a walk pass: the workers share the cores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(host, "walk_threads", lambda: 2)
        yield


def lump_reads(seed, n_genomes=4, genome_len=3000, n_repeats=4,
               repeat_len=250, copies=3, n_reads=1500, length=100,
               sub=0.005):
    """Reads of `n_genomes` random genomes into each of which the same
    `n_repeats` repeats are inserted `copies` times: one partition whose
    repeats are knots."""
    rng = np.random.default_rng(seed)
    repeats = [rng.integers(0, 4, repeat_len) for _ in range(n_repeats)]
    genomes = []
    for _ in range(n_genomes):
        base = rng.integers(0, 4, genome_len)
        cuts = np.sort(rng.integers(0, genome_len, n_repeats * copies))
        parts, last = [], 0
        for j, c in enumerate(cuts):
            parts += [base[last:c], repeats[j % n_repeats]]
            last = c
        genomes.append(np.concatenate(parts + [base[last:]]))
    out = []
    for _ in range(n_reads):
        g = genomes[int(rng.integers(0, n_genomes))]
        s = int(rng.integers(0, len(g) - length))
        r = g[s:s + length].copy()
        hit = rng.random(length) < sub
        r[hit] = rng.integers(0, 4, int(hit.sum()))
        out.append("".join("ACGT"[c] for c in r))
    return out


def _jax_graph(monkeypatch, engine, seqs, x=2e5):
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    g = JaxNodegraph(K_SIZE, x, 4)
    for s in seqs:
        g.consume_and_tag(s)
    return g


def _port_graph(jg, stop_tags=None):
    """The port's Nodegraph on the CPU holding a JAX Nodegraph's state."""
    return Nodegraph.from_numpy_state(
        jg.ksize(), jg._primes, [np.asarray(t) for t in jg.tables], 0, 0,
        device="cpu", all_tags=jg.all_tags,
        stop_tags=jg.stop_tags if stop_tags is None else stop_tags,
        tag_density=jg._tag_density)


@pytest.fixture(scope="module")
def lump():
    """The lump's reads and, under JAX's native engine, its graph."""
    seqs = lump_reads(17)
    with pytest.MonkeyPatch.context() as mp:
        jg = _jax_graph(mp, "auto", seqs)
    return seqs, jg


@pytest.fixture(scope="module")
def small_lump():
    """A smaller lump (two genomes), for the walks one tag a batch."""
    seqs = lump_reads(29, n_genomes=2, genome_len=2000, n_reads=700)
    with pytest.MonkeyPatch.context() as mp:
        jg = _jax_graph(mp, "auto", seqs)
    return seqs, jg


# -- (a) the stop-tag file ---------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 97])
def test_save_stoptags_bytes_match_jax(n, tmp_path):
    """Type 4: the header, then the stop tags ascending as u64, values
    past 2^63 included; the port reads back what it wrote."""
    rng = np.random.default_rng(n)
    tags = set(int(v) for v in rng.integers(0, 2**64, n, dtype=np.uint64))
    oxli_io.save_stoptags(str(tmp_path / "port"), K_SIZE, tags)
    jax_oxli.save_stoptags(str(tmp_path / "jax"), K_SIZE, tags)
    blob = (tmp_path / "port").read_bytes()
    assert blob == (tmp_path / "jax").read_bytes()
    assert len(blob) == 18 + 8 * n
    assert oxli_io.load_stoptags(str(tmp_path / "port"), K_SIZE) == tags


def test_graph_stop_tag_files_match_jax(lump, tmp_path):
    """save_stop_tags, print_stop_tags and print_tagset of a graph with
    stop tags, and trim_on_stoptags on its reads, as JAX's."""
    seqs, jg = lump
    stops = set(sorted(jg.all_tags)[::3])
    pg = _port_graph(jg, stops)
    jg2 = JaxNodegraph(K_SIZE, 1, 1)
    jg2.stop_tags = set(stops)
    jg2.all_tags = set(jg.all_tags)
    for name in ("save_stop_tags", "print_stop_tags", "print_tagset"):
        getattr(pg, name)(str(tmp_path / ("port." + name)))
        getattr(jg2, name)(str(tmp_path / ("jax." + name)))
        assert (tmp_path / ("port." + name)).read_bytes() == \
            (tmp_path / ("jax." + name)).read_bytes()
    reads = seqs[:200] + ["ACGT", ""]
    trims = [pg.trim_on_stoptags(s) for s in reads]
    assert trims == [jg2.trim_on_stoptags(s) for s in reads]
    assert any(at < len(s) for s, (_, at) in zip(reads, trims))


# -- (b) the bounded-radius traversal ----------------------------------------


def _jax_traverse(monkeypatch, engine, jg, kmer, radius, max_count):
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    keeper = set()
    count = JT.traverse_from_kmer(jg, kmer, radius, max_count=max_count,
                                  keeper=keeper)
    return count, keeper


@pytest.mark.parametrize("engine", ["device", "auto"])
@pytest.mark.parametrize("stops", ["none", "every-fifth-tag"])
def test_traverse_from_kmer_matches_jax(engine, stops, lump, monkeypatch):
    """Counts and keepers of traversals from tags and from a k-mer string,
    at radii 0, 1, 7 and 40 and with max_count, with and without stop
    tags: the batched walk, its plain reference and JAX's. Where JAX's
    level BFS cuts a traversal at max_count elsewhere than its native
    engine (see the test below), the port gives the native engine's."""
    seqs, jg = lump
    jg = _jax_graph(monkeypatch, engine, seqs)
    tags = sorted(jg.all_tags)
    if stops != "none":
        jg.stop_tags = set(tags[::5])
    pg = _port_graph(jg)
    starts = tags[1:200:23] + [tags[0], seqs[3][10:10 + K_SIZE]]
    for kmer in starts:
        for radius, max_count in ((0, 0), (1, 0), (7, 0), (40, 0),
                                  (40, 60), (40, 3)):
            want = _jax_traverse(monkeypatch, engine, jg, kmer, radius,
                                 max_count)
            got = set()
            got = (T.traverse_from_kmer(pg, kmer, radius, max_count,
                                        keeper=got), got)
            f, r = T._start(pg, kmer)
            assert T.bfs(pg, f, r, radius=radius,
                         max_count=max_count) == got
            if got != want:
                native = _jax_traverse(monkeypatch, "auto", jg, kmer,
                                       radius, max_count)
                assert engine == "device" and max_count
                assert got == native != want
    if stops != "none":
        # a stop-tag start keeps nothing
        assert T.traverse_from_kmer(pg, tags[0], RADIUS) == 0


def test_traversal_where_jax_engines_differ(lump, monkeypatch):
    """With max_count, JAX's level BFS (the device engine) queues a node's
    neighbours with the bases in the order A, T, C, G, and the reference
    and the native engine in the order A, C, G, T; so where max_count cuts
    a level, the two engines keep different nodes. On the lump with every
    fifth tag a stop tag, the traversal of radius 40 from one tag, cut at
    61 nodes, keeps one node the other does not; the port keeps the
    native engine's nodes."""
    seqs, jg = lump
    tags = sorted(jg.all_tags)
    jg.stop_tags = set(tags[::5])
    try:
        pg = _port_graph(jg)
        start = 90149389315
        assert start in jg.all_tags
        device = _jax_traverse(monkeypatch, "device", jg, start, 40, 60)
        native = _jax_traverse(monkeypatch, "auto", jg, start, 40, 60)
    finally:
        jg.stop_tags = set()
    got = set()
    got = (T.traverse_from_kmer(pg, start, 40, 60, keeper=got), got)
    assert device[0] == native[0] == 61
    assert len(device[1] ^ native[1]) == 2
    assert got == native


def test_excursion_walk_batches_and_threads_change_nothing(lump,
                                                           monkeypatch):
    """One walk of many traversals, on two threads, keeps what each keeps
    alone on one."""
    _, jg = lump
    pg = _port_graph(jg, set(sorted(jg.all_tags)[::7]))
    tags = np.array(sorted(jg.all_tags)[:300], np.uint64)
    rc = P.revcomp_bits(tags, K_SIZE)
    walk = T.walk_excursions(pg, tags, rc, RADIUS)
    counts, kept = walk.counts(), walk.keepers()
    walk.close()
    monkeypatch.setattr(host, "walk_threads", lambda: 1)
    for i in range(0, len(tags), 37):
        one = T.walk_excursions(pg, tags[i:i + 1], rc[i:i + 1], RADIUS)
        assert one.counts()[0] == counts[i]
        lo = int(counts[:i].sum())
        assert (one.keepers() == kept[lo:lo + counts[i]]).all()
        one.close()
    assert counts.max() >= THRESHOLD > counts.min()


def test_keepers_into_a_buffer_and_the_staging(lump):
    """The walk writes the keepers into the head of a given buffer, as
    keepers() returns them, and refuses one too short; partition._Staging
    hands them to M and the counters back unchanged."""
    _, jg = lump
    pg = _port_graph(jg, set())
    tags = np.array(sorted(jg.all_tags)[:60], np.uint64)
    walk = T.walk_excursions(pg, tags, P.revcomp_bits(tags, K_SIZE), RADIUS)
    try:
        want = walk.keepers(THRESHOLD)
        m = walk.n_keepers(THRESHOLD)
        assert m == len(want) > 0
        buf = np.full(m + 5, 7, np.uint64)
        got = walk.keepers(THRESHOLD, out=buf)
        assert (got == want).all() and (buf[:m] == want).all()
        assert (buf[m:] == 7).all()
        with pytest.raises(ValueError, match="at least"):
            walk.keepers(THRESHOLD, out=np.empty(m - 1, np.uint64))
        staging = P._Staging(torch.device("cpu"))
        up = staging.upload(walk, THRESHOLD)
        assert up.dtype == torch.int64
        assert (up.numpy().view(np.uint64) == want).all()
        base = torch.from_numpy(np.arange(3 * m, dtype=np.uint8).reshape(
            3, m))
        assert (staging.download(base) == base.numpy()).all()
    finally:
        walk.close()


# -- (c) kernel M's plain version --------------------------------------------


@pytest.mark.parametrize("ntables", [1, 4, 8])
@pytest.mark.parametrize("n", [0, 1, 1000, 2047, 2048, 2049])
def test_byte_pertable_plain_matches_jax(ntables, n):
    """Every table's counter of hashes of every range (past 2^63
    included), against make_pertable_get("byte"), with saturated
    counters; n around kernel M's hashes a block (2048)."""
    rng = np.random.default_rng(10 * ntables + n)
    primes = tuple(K.get_n_primes_near_x(ntables, 7000))
    flat = rng.integers(0, 256, K.byte_flat_size(primes), dtype=np.uint8)
    flat[::11] = 255
    views = tuple(jnp.asarray(flat[o:o + p])
                  for o, p in zip(K.byte_offsets(primes), primes))
    hashes = rng.integers(0, 2**64, n, dtype=np.uint64)
    hashes[:n // 3] |= np.uint64(1 << 63)
    want = np.asarray(JK.make_pertable_get("byte", primes)(
        views, jnp.asarray(hashes)))
    tensor = torch.from_numpy(hashes.view(np.int64).copy())
    got = K.byte_pertable_plain(primes, torch.from_numpy(flat), tensor)
    assert got.dtype == torch.uint8 and got.shape == (ntables, n)
    assert (got.numpy() == want).all()
    cg = Countgraph(K_SIZE, 1, 1, primes=primes, device="cpu")
    cg.tables.flat.copy_(torch.from_numpy(flat))
    assert (K.pertable_counts("byte", primes, cg.tables, tensor).numpy()
            == want).all()


@pytest.mark.parametrize("n,offset", [(2049, 1), (2048, 3),
                                      ((1 << 21) + 3, 1)])
def test_byte_pertable_plain_matches_jax_on_views(n, offset):
    """A hash view at an odd element offset (not 16-byte aligned), as
    kernel M's edge cases take it, and n over a chunk of 2^21 hashes,
    against make_pertable_get("byte") on the same hashes."""
    rng = np.random.default_rng(n + offset)
    primes = tuple(K.get_n_primes_near_x(4, 70000))
    flat = rng.integers(0, 256, K.byte_flat_size(primes), dtype=np.uint8)
    whole = rng.integers(0, 2**64, n + offset, dtype=np.uint64)
    views = tuple(jnp.asarray(flat[o:o + p])
                  for o, p in zip(K.byte_offsets(primes), primes))
    want = np.asarray(JK.make_pertable_get("byte", primes)(
        views, jnp.asarray(whole[offset:])))
    tensor = torch.from_numpy(whole.view(np.int64))[offset:]
    assert tensor.storage_offset() == offset and tensor.is_contiguous()
    got = K.byte_pertable_plain(primes, torch.from_numpy(flat), tensor)
    assert got.shape == (4, n) and (got.numpy() == want).all()


def test_pertable_counts_other_tables_are_not_yet_ported():
    primes = (101, 103)
    ng = Nodegraph(K_SIZE, 1, 1, primes=primes, device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        K.pertable_counts("bit", primes, ng.tables,
                          torch.zeros(3, dtype=torch.int64))


# -- (d) repartition_largest_partition --------------------------------------


def _repartition_state(graph, subset, counting, size):
    ids = {int(t): subset.get_partition_id(t) for t in graph.all_tags}
    return (size, set(graph.stop_tags), set(graph.repart_small_tags), ids,
            [np.asarray(t).tobytes() for t in counting.tables])


# counting tables (size a table, frequency, tables): small enough that
# k-mers share bins; so small, with a frequency past 255, that the
# counters saturate and the stop tags come from the adds within a walk;
# and more tables than the card's kernels take (the CPU's evaluation
# holds any number), with a batch's adds in most bins of every table
COUNTINGS = {"shared-bins": (3e4, FREQUENCY, 4), "saturated": (61, 260, 4),
             "33-tables": (1e3, FREQUENCY, 33)}
REPARTITIONS = [("small", 1, "shared-bins"), ("lump", 7, "shared-bins"),
                ("lump", None, "shared-bins"), ("small", None, "saturated"),
                ("small", None, "33-tables")]


@pytest.fixture(scope="module")
def jax_repartitions(lump, small_lump, tmp_path_factory):
    """JAX's repartition of each lump's one partition (native engine) with
    each counting table of REPARTITIONS: its returned size, stop tags,
    small tags, tag ids, counting tables and saved .pmap."""
    out = {}
    d = tmp_path_factory.mktemp("jax-repart")
    graphs = {"lump": lump[1], "small": small_lump[1]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KHMER_TPU_ENGINE", "auto")
        for name, _, kind in REPARTITIONS:
            if (name, kind) in out:
                continue
            jg = graphs[name]
            jg.stop_tags = set()
            subset = jg.do_subset_partition(0, 0)
            x, frequency, ntables = COUNTINGS[kind]
            counting = JaxCountgraph(32, x, ntables)
            size = jg.repartition_largest_partition(
                counting, RADIUS, THRESHOLD, frequency, subs=subset)
            path = d / ("%s-%s" % (name, kind))
            subset.save_partitionmap(str(path))
            out[name, kind] = (_repartition_state(jg, subset, counting,
                                                  size), path.read_bytes())
            jg.stop_tags = set()
            del jg.repart_small_tags
    return out


@pytest.mark.parametrize("name,batch,kind", REPARTITIONS)
def test_repartition_matches_jax(name, batch, kind, lump, small_lump,
                                 jax_repartitions, monkeypatch, tmp_path):
    """The stop tags, small tags, partition ids, .pmap bytes, counting
    tables and returned size of JAX's repartition, whatever the batch;
    the default batch walks some tags again, after stop tags that tags
    before them in the batch added."""
    _, jg = {"lump": lump, "small": small_lump}[name]
    pg = _port_graph(jg, set())
    if batch:
        monkeypatch.setattr(P, "REPART_BATCH", batch)
    rewalks = []
    evaluate = host.ExcursionWalk.evaluate

    def counted(self, *args):
        out = evaluate(self, *args)
        rewalks.append(int(out[3].sum()))
        return out

    monkeypatch.setattr(host.ExcursionWalk, "evaluate", counted)
    subset = pg.do_subset_partition(0, 0)
    assert subset.count_partitions() == (1, 0)
    x, frequency, ntables = COUNTINGS[kind]
    counting = Countgraph(32, x, ntables, device="cpu")
    size = pg.repartition_largest_partition(
        counting, RADIUS, THRESHOLD, frequency, subs=subset)
    subset.save_partitionmap(str(tmp_path / "port"))
    want, pmap = jax_repartitions[name, kind]
    got = _repartition_state(pg, subset, counting, size)
    assert got[0] == want[0]
    assert got[1] == want[1] and got[1]
    assert got[2] == want[2] and got[2]
    assert got[3] == want[3] and len(set(got[3].values())) > 1
    assert got[4] == want[4]
    assert (tmp_path / "port").read_bytes() == pmap
    if batch is None:
        assert sum(rewalks) > 0 and len(rewalks) >= 1
    if batch == 1:
        assert sum(rewalks) == 0
    if kind == "saturated":
        assert max(b for t in counting.tables for b in t.tolist()) == 255


def test_repartition_needs_a_partition(lump):
    _, jg = lump
    pg = _port_graph(jg, set())
    with pytest.raises(RuntimeError, match="no partitions"):
        P.SubsetPartition(pg).repartition_largest_partition(
            RADIUS, THRESHOLD, FREQUENCY, Countgraph(32, 1e3, 4,
                                                     device="cpu"))


# -- (f) no JAX -------------------------------------------------------------


def test_knot_modules_import_no_jax():
    code = ("import sys, khmer_tpu_torch.core.traversal, "
            "khmer_tpu_torch.cli.make_initial_stoptags, "
            "khmer_tpu_torch.cli.find_knots, "
            "khmer_tpu_torch.cli.filter_stoptags, "
            "khmer_tpu_torch.cli.extract_partitions; "
            "print([m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'khmer_tpu.')) or m == 'khmer_tpu'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
