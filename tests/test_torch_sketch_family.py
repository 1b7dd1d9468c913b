"""The sketch family of the port (khmer_tpu_torch) against the JAX package
on the CPU: the murmur family of the host hasher against the scalar
murmur hash; the five table classes (Counttable, SmallCounttable,
Nodetable, BlockedCounttable, CyclicCounttable) consuming a read file at
k 20, 31 and 32 under both JAX engines (KHMER_TPU_ENGINE=auto, the dense
host hash; =device, the windowed device murmur), their OXLI files and
loaders; the masked and banded consumes (kernel S's plain version) under
masks of every layout; the sequence count ops on every kind;
Nodegraph.update; the abundance histogram of a murmur table; and the
murmur and cyclic cases of JAX's tests/test_tabletype_parity.py,
test_tabletype_breadth.py and test_consume_with_mask.py, which need the
reference's data files there and are built here from their sequences.

Tolerance: exact everywhere (integer state, float32 sums taken in the
same order)."""

import gzip
import os

import numpy as np
import pytest
import torch

import khmer_tpu as J
from khmer_tpu.core import blocked as JB
from khmer_tpu.io.fastx import FastxParser as JaxParser
from khmer_tpu.ops import hashing as JH
import khmer_tpu_torch as T
from khmer_tpu_torch.core import hostengine, pipeline
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.blocked import BlockedCountgraph, BlockedCounttable
from khmer_tpu_torch.io.fastx import FastxParser
from khmer_tpu_torch.ops import hashing as H
from khmer_tpu_torch.scripts import family_cases

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = os.path.join(REPO, "data", "stamps-reads.fa.gz")
X = 3e4  # each table's size: four tables of about 30,000 counters

# name -> (JAX class, port class)
TABLES = {
    "Counttable": (J.Counttable, T.Counttable),
    "SmallCounttable": (J.SmallCounttable, T.SmallCounttable),
    "Nodetable": (J.Nodetable, T.Nodetable),
    "BlockedCounttable": (JB.BlockedCounttable, BlockedCounttable),
    "CyclicCounttable": (J.CyclicCounttable, T.CyclicCounttable),
}
GRAPHS = {
    "Countgraph": (J.Countgraph, T.Countgraph),
    "SmallCountgraph": (J.SmallCountgraph, T.SmallCountgraph),
    "Nodegraph": (J.Nodegraph, T.Nodegraph),
    "BlockedCountgraph": (JB.BlockedCountgraph, BlockedCountgraph),
}
# (table, k, engine) the consume parity runs: every table at k 20, 31 and
# 32 under auto; the four murmur tables (the cyclic one has no engines)
# at k 20 and 32 under device too
CONSUMES = ([(name, k, "auto") for name in TABLES for k in (20, 31, 32)]
            + [(name, k, "device") for name in TABLES
               if name != "CyclicCounttable" for k in (20, 32)])


def family_reads(n=2000):
    """The first n stamps reads, one in forty with a run of lowercase
    bases and Ns, one in fifty cut shorter than k, and one read 300 times
    (its k-mers past 255: a Counttable's bigcount entries)."""
    out = []
    with gzip.open(STAMPS, "rt") as f:
        for line in f:
            if not line.startswith(">"):
                out.append(line.strip())
            if len(out) == n:
                break
    for i in range(0, n, 40):
        s = out[i]
        out[i] = s[:30] + s[30:50].lower() + "NNN" + s[53:]
    for i in range(7, n, 50):
        out[i] = out[i][:15]
    return out + [out[11]] * 300


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("family")
    seqs = family_reads()
    paths = {}
    for name, part in (("reads", seqs), ("first", seqs[:400]),
                       ("tail", seqs[1500:])):
        paths[name] = str(d / (name + ".fa"))
        with open(paths[name], "w") as f:
            for i, s in enumerate(part):
                f.write(">r%d\n%s\n" % (i, s))
    paths["seqs"] = seqs
    return paths


def _with_engine(engine, fn):
    os.environ["KHMER_TPU_ENGINE"] = engine
    try:
        return fn()
    finally:
        del os.environ["KHMER_TPU_ENGINE"]


def _consumed(cls, k, path, **kw):
    s = cls(k, X, 4, **kw)
    got = s.consume_seqfile(path)
    return s, tuple(int(v) for v in got)


@pytest.fixture(scope="module")
def jax_tables(reads):
    """{(table, k, engine): (JAX table consumed from the reads, (reads,
    k-mers))} of CONSUMES."""
    return {(name, k, engine): _with_engine(engine, lambda: _consumed(
        TABLES[name][0], k, reads["reads"])) for name, k, engine in CONSUMES}


@pytest.fixture(scope="module")
def port_tables(reads):
    """{(table, k): the port's table consumed from the reads (CPU)}."""
    return {(name, k): _consumed(TABLES[name][1], k, reads["reads"],
                                 device="cpu")
            for name, k in {(n, k) for n, k, _ in CONSUMES}}


def _raw(sketch):
    return [np.asarray(t).tobytes() for t in sketch.get_raw_tables()]


# -- the host hasher's murmur family ------------------------------------------


@pytest.mark.parametrize("k", [1, 15, 16, 17, 20, 31, 32])
def test_murmur_host_hash_matches_the_scalar_hash(k):
    """The dense host hasher's murmur family (csrc/dense_hash.cc) on
    seeded reads with palindromic windows against _hash_murmur_scalar of
    each window, the port's and JAX's, and against the numpy window hash;
    per read block and per flat chunk with read starts."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    pal = H.encode_dna("AATT" * 8 + "ACGT" * 8)
    codes[100:100 + len(pal)] = pal
    offs = np.array([0, 1000, 1010, 2200], np.int64)
    lens = np.array([1000, 10, 1190, 800], np.int64)
    got = hostengine.hash_dense_reads(codes, offs, lens, k, "murmur")
    want = []
    for o, n in zip(offs, lens):
        seq = "".join("ATCG"[c] for c in codes[o:o + n])
        mine = [H._hash_murmur_scalar(seq[i:i + k])[0]
                for i in range(n - k + 1)]
        assert [JH._hash_murmur_scalar(seq[i:i + k])[0]
                for i in range(0, n - k + 1, 97)] == mine[::97]
        want += mine
    assert got.tolist() == want
    numpy_h = np.concatenate([H.host_murmur_hash_windows(codes[o:o + n], k)
                              for o, n in zip(offs, lens)])
    assert (got == numpy_h).all()
    starts = np.concatenate([offs, np.full(3, 1 << 20)]).astype(np.int32)
    assert (hostengine.hash_dense(codes, starts, 3000, k, "murmur")
            == got).all()


# -- the five table classes ---------------------------------------------------


@pytest.mark.parametrize("name,k,engine", CONSUMES)
def test_table_consume_matches_jax(name, k, engine, reads, jax_tables,
                                   port_tables):
    """The consume of the reads: its (reads, k-mers), every table byte,
    n_unique, n_occupied and the bigcount map, against JAX's under the
    engine; then get and hash of the first read's k-mers."""
    jt, jgot = jax_tables[(name, k, engine)]
    pt, pgot = port_tables[(name, k)]
    assert pgot == jgot
    assert _raw(pt) == _raw(jt)
    assert pt.n_unique_kmers() == jt.n_unique_kmers()
    assert pt.n_occupied() == jt.n_occupied()
    assert pt._bigcounts == jt._bigcounts
    seq = reads["seqs"][1]
    for i in range(0, len(seq) - k + 1, 7):
        kmer = seq[i:i + k]
        assert pt.hash(kmer) == jt.hash(kmer)
        assert pt.get(kmer) == jt.get(kmer)
        assert pt.get(pt.hash(kmer)) == jt.get(kmer)
    assert pt.get_kmer_hashes(seq) == jt.get_kmer_hashes(seq)


@pytest.mark.parametrize("name", list(TABLES))
def test_table_count_ops_match_jax(name, reads, jax_tables, port_tables):
    """The six count ops, trim_below_abundance and
    find_spectral_error_positions of 60 reads (the short ones among them)
    against JAX's on the same tables."""
    jt, _ = jax_tables[(name, 20, "auto")]
    pt, _ = port_tables[(name, 20)]
    _assert_count_ops(pt, jt, reads["seqs"][:60] + [reads["seqs"][11]])


def _assert_count_ops(pt, jt, seqs):
    k = pt.ksize()
    for s in seqs:
        assert pt.get_kmer_counts(s) == jt.get_kmer_counts(s)
        assert pt.get_min_count(s) == jt.get_min_count(s)
        assert pt.get_max_count(s) == jt.get_max_count(s)
        for cut in (1, 2, 3):
            assert pt.trim_on_abundance(s, cut) == jt.trim_on_abundance(s, cut)
            assert pt.trim_below_abundance(s, cut) == \
                jt.trim_below_abundance(s, cut)
        if len(s) < k:
            continue
        assert pt.get_median_count(s) == jt.get_median_count(s)
        for cut in (1, 2, 4):
            assert pt.median_at_least(s, cut) == jt.median_at_least(s, cut)
            assert pt.find_spectral_error_positions(s, cut) == \
                jt.find_spectral_error_positions(s, cut)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_count_ops_match_jax(name, reads):
    """The same ops on the 2-bit kinds, every one now on _Sketch over the
    gather with its bigcount fix-up (a Countgraph's get_kmer_counts,
    median_at_least and trim_on_abundance through kernel H's plain
    version): Countgraph with bigcount, SmallCountgraph, Nodegraph and
    BlockedCountgraph."""
    jc, pc = GRAPHS[name]
    jg, pg = jc(20, X, 4), pc(20, X, 4, device="cpu")
    if name == "Countgraph":
        jg.set_use_bigcount(True)
        pg.set_use_bigcount(True)
    assert pg.consume_seqfile(reads["tail"]) == tuple(
        int(v) for v in jg.consume_seqfile(reads["tail"]))
    assert _raw(pg) == _raw(jg)
    _assert_count_ops(pg, jg, reads["seqs"][1500:1560]
                      + [reads["seqs"][11]])


@pytest.mark.parametrize("name", list(TABLES))
def test_table_files_match_jax(name, tmp_path, jax_tables, port_tables):
    """save() writes JAX's bytes (OXLI types 1, 2 and 7; the blocked type
    127), plain and gzipped; the loaders (load_counttable with and without
    small, load_nodetable, the class's load) read them back to the same
    tables and occupancy."""
    jt, _ = jax_tables[(name, 31, "auto")]
    pt, _ = port_tables[(name, 31)]
    for suffix in ("", ".gz"):
        mine, theirs = (str(tmp_path / (w + ".oxli" + suffix))
                        for w in ("mine", "theirs"))
        pt.save(mine)
        jt.save(theirs)
        if not suffix:
            assert open(mine, "rb").read() == open(theirs, "rb").read()
        loader = {
            "Counttable": lambda p: T.load_counttable(p, device="cpu"),
            "SmallCounttable": lambda p: T.load_counttable(p, small=True,
                                                           device="cpu"),
            "Nodetable": lambda p: T.load_nodetable(p, device="cpu"),
        }.get(name, lambda p: TABLES[name][1].load(p, device="cpu"))
        back = loader(theirs)
        assert type(back) is type(pt)
        assert _raw(back) == _raw(pt)
        assert back.n_occupied() == pt.n_occupied()
        assert back.ksize() == 31 and back.hashsizes() == pt.hashsizes()


def test_loaders_refuse_the_other_layout(tmp_path):
    """A Counttable file does not load as a SmallCounttable, nor a
    Nodetable's as a Counttable, as in JAX."""
    ct = str(tmp_path / "a.ct")
    T.Counttable(20, 1e3, 2, device="cpu").save(ct)
    nt = str(tmp_path / "a.nt")
    T.Nodetable(20, 1e3, 2, device="cpu").save(nt)
    with pytest.raises(OSError):
        T.load_counttable(ct, small=True, device="cpu")
    with pytest.raises(OSError):
        T.load_counttable(nt, device="cpu")
    with pytest.raises(OSError):
        J.core.oxli_io.load_counttable(ct, small=True)


# -- masked and banded consumes (kernel S's plain version) -------------------


def _mask_of(kind, path, k=20):
    """(JAX mask, the port's) of each layout, consumed from `path`."""
    cls = {"bit": "Nodegraph", "byte": "Countgraph",
           "nibble": "SmallCountgraph", "blocked": "BlockedCountgraph"}[kind]
    jc, pc = GRAPHS[cls]
    jm, pm = jc(k, 2e4, 4), pc(k, 2e4, 4, device="cpu")
    jm.consume_seqfile(path)
    pm.consume_seqfile(path)
    assert _raw(pm) == _raw(jm)
    return jm, pm


@pytest.mark.parametrize("engine", ["auto", "device"])
@pytest.mark.parametrize("consume_masked", [False, True])
def test_countgraph_under_a_nodegraph_mask(engine, consume_masked, reads):
    """A Countgraph (bigcount on) consumed under a Nodegraph mask of the
    first 400 reads at threshold 0, both ways: (reads, k-mers), tables,
    n_unique and bigcount map. JAX takes its windowed path (the hash on
    the device, the filter in the step) under both engines."""
    def run():
        jm, pm = _mask_of("bit", reads["first"])
        jg, pg = J.Countgraph(20, X, 4), T.Countgraph(20, X, 4, device="cpu")
        for g in (jg, pg):
            g.set_use_bigcount(True)
        return (jg.consume_seqfile_with_mask(reads["reads"], jm, 0,
                                             consume_masked), jg,
                pg.consume_seqfile_with_mask(reads["reads"], pm, 0,
                                             consume_masked), pg)
    jgot, jg, pgot, pg = _with_engine(engine, run)
    assert pgot == tuple(int(v) for v in jgot)
    assert _raw(pg) == _raw(jg)
    assert pg.n_unique_kmers() == jg.n_unique_kmers()
    assert pg._bigcounts == jg._bigcounts


@pytest.mark.parametrize("mask_kind,threshold,consume_masked", [
    ("byte", 1, False), ("byte", 2, True), ("nibble", 0, False),
    ("nibble", 15, True), ("blocked", 1, False), ("bit", 1, True)])
def test_masks_of_every_layout(mask_kind, threshold, consume_masked, reads):
    """A SmallCounttable consumed under a mask of each layout (its count
    the least counter, without the bigcount map, from the mask's gather:
    kernels B, Q, 2 and L's gather mode on the card)."""
    jm, pm = _mask_of(mask_kind, reads["first"])
    jt = J.SmallCounttable(20, X, 4)
    pt = T.SmallCounttable(20, X, 4, device="cpu")
    jgot = jt.consume_seqfile_with_mask(reads["tail"], jm, threshold,
                                        consume_masked)
    pgot = pt.consume_seqfile_with_mask(reads["tail"], pm, threshold,
                                        consume_masked)
    assert pgot == tuple(int(v) for v in jgot)
    assert _raw(pt) == _raw(jt)
    assert pt.n_unique_kmers() == jt.n_unique_kmers()


@pytest.mark.parametrize("name", ["Counttable", "Nodetable",
                                  "BlockedCounttable"])
def test_four_bands_tile_the_full_consume(name, reads, port_tables):
    """Four banded consumes of the reads into one table: each band's
    (reads, k-mers) and tables as JAX's, and the summed tables equal the
    full consume's byte for byte (a Counttable, whose counts add)."""
    jc, pc = TABLES[name]
    jt, pt = jc(20, X, 4), pc(20, X, 4, device="cpu")
    total = 0
    for band in range(4):
        jgot = jt.consume_seqfile_banding(reads["reads"], 4, band)
        pgot = pt.consume_seqfile_banding(reads["reads"], 4, band)
        assert pgot == tuple(int(v) for v in jgot)
        assert _raw(pt) == _raw(jt)
        total += pgot[1]
    full, (_, n_full) = port_tables[(name, 20)]
    assert total == n_full
    if name != "Nodetable":
        assert _raw(pt) == _raw(full)


def test_banding_with_a_mask(reads):
    """consume_seqfile_banding_with_mask: a Counttable's band 1 of 3
    under a Counttable mask at threshold 2, against JAX."""
    jm, pm = J.Counttable(20, 2e4, 4), T.Counttable(20, 2e4, 4, device="cpu")
    jm.consume_seqfile(reads["first"])
    pm.consume_seqfile(reads["first"])
    jt, pt = J.Counttable(20, X, 4), T.Counttable(20, X, 4, device="cpu")
    jgot = jt.consume_seqfile_banding_with_mask(reads["reads"], 3, 1, jm, 2)
    pgot = pt.consume_seqfile_banding_with_mask(reads["reads"], 3, 1, pm, 2)
    assert pgot == tuple(int(v) for v in jgot)
    assert _raw(pt) == _raw(jt)
    assert pt.n_unique_kmers() == jt.n_unique_kmers()


def test_band_interval_matches_jax():
    for num, band in ((1, 0), (4, 0), (4, 3), (7, 5), (1000, 999)):
        assert H.compute_band_interval(num, band) == \
            JH.compute_band_interval(num, band)
    with pytest.raises(ValueError):
        H.compute_band_interval(4, 4)


@pytest.mark.parametrize("name", list(family_cases.FILTER_CASES))
def test_consume_filter_plain_matches_jax_filters(name):
    """Kernel S's plain version on its cases against JAX's filter rule
    (pipeline.py _band_filter and make_mask_filter's comparison, in
    numpy u64): the kept hashes in stream order and their count."""
    hashes, nvalid, band, counts, threshold, at_least = \
        family_cases.filter_inputs(name)
    out, n = K.consume_filter_plain(hashes, nvalid, band, counts,
                                    threshold, at_least)
    h = hashes.numpy().view(np.uint64)
    keep = np.arange(len(h)) < nvalid
    if band is not None:
        keep &= (h >= np.uint64(band[0])) & (h < np.uint64(band[1]))
    if counts is not None:
        c = counts.numpy()
        keep &= (c >= threshold) if at_least else (c <= threshold)
    want = h[keep]
    assert int(n[0]) == len(want)
    assert (out.numpy().view(np.uint64)[:len(want)] == want).all()
    assert not out[len(want):].any()


def test_masked_consume_with_a_small_dense_chunk(reads, monkeypatch):
    """Chunks of 777 k-mers (reads straddle them; the tail is short):
    the masked consume still gives JAX's tables."""
    monkeypatch.setattr(pipeline, "DENSE_CHUNK", 777)
    jm, pm = _mask_of("nibble", reads["first"])
    jt, pt = J.Counttable(20, X, 4), T.Counttable(20, X, 4, device="cpu")
    assert pt.consume_seqfile_banding_with_mask(reads["tail"], 2, 0, pm, 1) \
        == tuple(int(v) for v in jt.consume_seqfile_banding_with_mask(
            reads["tail"], 2, 0, jm, 1))
    assert _raw(pt) == _raw(jt)


# -- Nodegraph.update, the histogram of a murmur table ---------------------


def test_nodegraph_update_matches_jax(reads):
    """The OR of two equal-shaped Nodegraphs: tables, n_unique (the larger
    of the two), occupancy; unequal shapes raise."""
    pair = {}
    for side, (cls, kw) in (("jax", (J.Nodegraph, {})),
                            ("port", (T.Nodegraph, {"device": "cpu"}))):
        a, b = cls(20, X, 4, **kw), cls(20, X, 4, **kw)
        a.consume_seqfile(reads["first"])
        b.consume_seqfile(reads["tail"])
        a.update(b)
        pair[side] = a
    assert _raw(pair["port"]) == _raw(pair["jax"])
    assert pair["port"].n_unique_kmers() == pair["jax"].n_unique_kmers()
    assert pair["port"].n_occupied() == pair["jax"].n_occupied()
    with pytest.raises(ValueError):
        pair["port"].update_from(T.Nodegraph(20, 1e3, 4, device="cpu"))


@pytest.mark.parametrize("name", ["Counttable", "SmallCounttable"])
def test_abundance_distribution_with_reads_parser(name, reads, jax_tables,
                                                  port_tables):
    """A murmur table's histogram over the reads, deduplicated by a
    Nodetable, from a parser: JAX's."""
    jt, _ = jax_tables[(name, 20, "auto")]
    pt, _ = port_tables[(name, 20)]
    want = jt.abundance_distribution_with_reads_parser(
        JaxParser(reads["tail"]), J.Nodetable(20, X, 4))
    got = pt.abundance_distribution_with_reads_parser(
        FastxParser(reads["tail"]), T.Nodetable(20, X, 4, device="cpu"))
    assert got == [int(v) for v in want]


# -- JAX's murmur and cyclic test cases, on the port -------------------------

K13 = 13
SEQ_A = "TAGATCTGCTTGAAACAAGTGGATTTGAGAAAAA"
SEQ_B = "TAGATCTGCTTGAAACAAGTGGATTTGAGAAAAAAGT"
IN_MASK = "GATTTGAGAAAAA"
NEW1, NEW2, NEW3 = "ATTTGAGAAAAAA", "TTTGAGAAAAAAG", "TTGAGAAAAAAGT"


@pytest.fixture(scope="module")
def seq_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("seqs")
    out = {}
    for name, seq in (("a", SEQ_A), ("b", SEQ_B)):
        out[name] = str(d / ("seq-%s.fa" % name))
        with open(out[name], "w") as f:
            f.write(">%s\n%s\n" % (name, seq))
    return out


def test_consume_with_mask_oracles(seq_files):
    """tests/test_consume_with_mask.py's oracles (the reference's
    test_counttable.py:83-196): only k-mers absent from, or below the
    threshold in, the mask load; consume_masked inverts the rule; banding
    composes with masking."""
    mask = T.Counttable(K13, 1e3, 4, device="cpu")
    mask.consume_seqfile(seq_files["a"])
    ct = T.Counttable(K13, 1e3, 4, device="cpu")
    assert ct.consume_seqfile_with_mask(seq_files["b"], mask) == (1, 3)
    assert [ct.get(s) for s in (IN_MASK, NEW1, NEW2, NEW3)] == [0, 1, 1, 1]
    ct = T.Counttable(K13, 1e3, 4, device="cpu")
    assert ct.consume_seqfile_banding_with_mask(seq_files["b"], 4, 1,
                                                mask) == (1, 1)
    assert [ct.get(s) for s in (IN_MASK, NEW1, NEW2, NEW3)] == [0, 0, 0, 1]
    mask = T.Counttable(K13, 1e3, 4, device="cpu")
    for _ in range(3):
        mask.consume(SEQ_A)
    for _ in range(2):
        mask.consume(SEQ_B)
    ct = T.Counttable(K13, 1e3, 4, device="cpu")
    assert ct.consume_seqfile_with_mask(seq_files["b"], mask, 3) == (1, 3)
    assert [ct.get(s) for s in (IN_MASK, NEW1, NEW2, NEW3)] == [0, 1, 1, 1]
    mask = T.Nodetable(K13, 1e3, 4, device="cpu")
    mask.consume("TGCTTGAAACAAGTG")
    ct = T.Counttable(K13, 1e3, 4, device="cpu")
    ct.consume_seqfile_with_mask(seq_files["b"], mask, threshold=1,
                                 consume_masked=True)
    assert ct.get_kmer_counts("TGCTTGAAACAAGTG") == [1, 1, 1]
    assert ct.get_kmer_counts("GAAACAAGTGGATTT") == [0, 0, 0]
    full = T.Counttable(K13, 1e4, 4, device="cpu")
    full.consume_seqfile(seq_files["b"])
    banded = T.Counttable(K13, 1e4, 4, device="cpu")
    assert sum(banded.consume_seqfile_banding(seq_files["b"], 4, band)[1]
               for band in range(4)) == len(SEQ_B) - K13 + 1
    assert _raw(banded) == _raw(full)


ALL_TYPES = [T.Counttable, T.SmallCounttable, T.Nodetable, T.Countgraph,
             T.SmallCountgraph, T.Nodegraph, T.CyclicCounttable,
             BlockedCounttable]
COUNTING = [T.Counttable, T.SmallCounttable, T.Countgraph,
            T.SmallCountgraph, T.CyclicCounttable, BlockedCounttable]
SAVING = [T.Counttable, T.SmallCounttable, T.Nodetable, T.Countgraph,
          T.SmallCountgraph, T.Nodegraph, BlockedCounttable]


def _make(cls, k=12, size=1e5, n=4):
    return cls(k, size, n, device="cpu")


@pytest.mark.parametrize("cls", ALL_TYPES)
def test_breadth_on_every_type(cls):
    """test_tabletype_breadth.py's and test_tabletype_parity.py's cases
    on each type: presence by k-mer and by hash, canonical counts,
    n_unique of distinct k-mers, get_kmer_counts, min and max, k-mer
    hashes, wrong-length k-mers."""
    tt = _make(cls)
    kmer = "G" * 12
    assert tt.get(kmer) == 0 and tt.get(tt.hash(kmer)) == 0
    tt.add(kmer)
    assert tt.get(kmer) == 1 and tt.get(tt.hash(kmer)) == 1
    tt = _make(cls, k=6)
    tt.count("ATGGCA")
    assert tt.get("ATGGCA") == 1 and tt.get("TGCCAT") == 1
    assert tt.get("GGGGGG") == 0
    with pytest.raises(ValueError):
        tt.hash("ATG")
    with pytest.raises(ValueError):
        tt.get("ATG")
    assert tt.get_kmers("ATGGCA") == ["ATGGCA"]
    tt = _make(cls)
    seq = "ATGGCAGTAGGACC"
    tt.consume(seq)
    assert tt.n_unique_kmers() == 3
    tt.consume(seq)
    assert tt.n_unique_kmers() == 3
    tt = _make(cls)
    tt.consume(seq)
    assert list(tt.get_kmer_counts(seq)) == [1, 1, 1]
    tt.add(seq[:12])
    node = "Node" in cls.__name__
    assert tt.get_min_count(seq) == 1
    assert tt.get_max_count(seq) == (1 if node else 2)
    assert tt.get_kmer_hashes(seq) == [tt.hash(seq[i:i + 12])
                                       for i in range(3)]
    with pytest.raises(ValueError):
        tt.hash("ATGYCGATXX")


@pytest.mark.parametrize("cls", COUNTING)
def test_counting_breadth(cls):
    """Saturation (15 for the nibble tables), the median, median_at_least,
    the trims and the spectral error positions on each counting type."""
    tt = _make(cls)
    for _ in range(20):
        tt.add("G" * 12)
    assert tt.get("G" * 12) == min(20, 15 if "Small" in cls.__name__
                                   else 255)
    seq = "ATGGCAGTAGGACC"
    tt = _make(cls)
    for _ in range(4):
        tt.consume(seq)
    assert tt.get_median_count(seq) == (4, 4.0, 0.0)
    assert tt.median_at_least(seq, 4) and not tt.median_at_least(seq, 5)
    tt = _make(cls)
    long_seq = "ATGGCAGTAGGACCAATTGG"
    tt.consume(long_seq[:16])
    assert tt.trim_on_abundance(long_seq, 1) == (long_seq[:16], 16)
    for _ in range(2):
        tt.consume(long_seq[:16])
    assert tt.trim_below_abundance(long_seq, 2) == ("", 0)
    tt = _make(cls, k=8)
    for _ in range(5):
        tt.consume(long_seq)
    bad = long_seq[:10] + "C" + long_seq[11:]
    tt.consume(bad)
    assert tt.find_spectral_error_positions(bad, 2) == [10]


@pytest.mark.parametrize("cls", SAVING)
@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_save_load_roundtrip(cls, suffix, tmp_path):
    """Counts and occupancy survive a save and a load (n_unique does not:
    the format does not hold it)."""
    tt = _make(cls)
    tt.consume("ATGGCAGTAGGACC")
    tt.add("G" * 12)
    fn = str(tmp_path / ("t.bin" + suffix))
    tt.save(fn)
    back = cls.load(fn, device="cpu")
    assert back.ksize() == 12
    assert back.get("ATGGCAGTAGGA") == tt.get("ATGGCAGTAGGA") == 1
    assert back.get("G" * 12) == tt.get("G" * 12)
    assert back.n_occupied() == tt.n_occupied()


def test_counttable_bigcount_roundtrip(tmp_path):
    tt = _make(T.Counttable)
    tt.set_use_bigcount(True)
    for _ in range(300):
        tt.add("G" * 12)
    assert tt.get("G" * 12) == 300
    fn = str(tmp_path / "big.ct")
    tt.save(fn)
    back = T.Counttable.load(fn, device="cpu")
    assert back.get("G" * 12) == 300 and back.get_use_bigcount()


@pytest.mark.parametrize("cls", [T.Counttable, T.SmallCounttable,
                                 T.Nodetable, T.CyclicCounttable,
                                 BlockedCounttable])
def test_murmur_and_cyclic_tables_do_not_reverse(cls):
    tt = _make(cls, k=6)
    with pytest.raises(ValueError):
        tt.reverse_hash(17)


def test_cyclic_counttable():
    ct = _make(T.CyclicCounttable, k=6)
    ct.count("ATGGCA")
    assert ct.get("ATGGCA") == 1 and ct.get("TGCCAT") == 1
    assert ct.get("CCCCCC") == 0
    assert ct.consume("ATGGCAAT") == 3
    assert ct.get("ATGGCA") == 2
    assert ct.hash("ATGGCA") == J.CyclicCounttable(6, 1e3, 2).hash("ATGGCA")


@pytest.mark.parametrize("cls", ALL_TYPES)
@pytest.mark.parametrize("k", [31, 32, 33])
def test_k_limit_and_explicit_primes(cls, k):
    """k up to 32 (H.KSIZE_MAX, shared by every family); explicit primes
    give the table sizes."""
    primes = K.get_n_primes_near_x(4, 1500)
    if k > H.KSIZE_MAX:
        with pytest.raises(ValueError):
            cls(k, 1e3, 4, device="cpu")
        return
    if cls is BlockedCounttable:
        primes = primes[:1]
    sketch = cls(k, 1, 1, primes=primes, device="cpu")
    assert sketch.ksize() == k
    if cls is not BlockedCounttable:
        assert sketch.hashsizes() == primes
    seq = "ACGT" * 10
    sketch.consume(seq)
    assert sketch.get(seq[:k]) >= 1
