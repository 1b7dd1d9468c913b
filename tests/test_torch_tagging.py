"""Kernel J's plain version, the Nodegraph's tagged consume, the C++
tag-spacing pass, OXLI tagsets and the load-graph CLI of the port
(khmer_tpu_torch) against the JAX package, exactly, on the CPU: the
bit-table update's per-event new flags and n_unique against JAX's
_update_dispatch, and every output under both JAX engines
(KHMER_TPU_ENGINE=auto, the native host tier; =device, the flat device
path)."""

import importlib
import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu import Nodegraph as JaxNodegraph
from khmer_tpu.core import oxli_io as jax_oxli
from khmer_tpu.core import pipeline as jax_pipeline
from khmer_tpu.core import sketch_kernels as JK
from khmer_tpu_torch.core import oxli_io, pipeline
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.graphmixin import dense_hashes, read_blocks
from khmer_tpu_torch.core.sketch import Nodegraph
from khmer_tpu_torch.io.fastx import FastxParser
from khmer_tpu_torch.ops.host import TagSpacing

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOMES = os.path.join(REPO, "data", "stamps-genomes.fa")
STAMPS = os.path.join(REPO, "data", "stamps-reads.fa.gz")
ENGINES = ["auto", "device"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64)
                            .view(np.int64).copy())


# -- kernel J's plain version against JAX's bit update ----------------------


def _batches(seed, primes, m, n_batches, kind):
    """Seeded batches: (hashes u64 [m], valid bool [m], nvalid)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        if kind == "crowded":
            # every hash on the first 40 bits of each table
            prod = int(np.prod([int(p) for p in primes]))
            low = rng.integers(0, 40, m, dtype=np.uint64)
            mult = rng.integers(0, 2**64 // prod, m, dtype=np.uint64)
            h = low + mult * np.uint64(prod)
        elif kind == "repeats":
            pool = rng.integers(0, 2**64, 50, dtype=np.uint64)
            h = pool[rng.integers(0, 50, m)]
        else:  # full range, half of them >= 2^63
            h = rng.integers(0, 2**64, m, dtype=np.uint64)
            h[::2] |= np.uint64(1 << 63)
        valid = rng.random(m) < 0.85
        nvalid = m - 37 * b
        out.append((h, valid, nvalid))
    return out


@pytest.mark.parametrize("kind", ["crowded", "repeats", "full"])
@pytest.mark.parametrize("primes", [(1009,), (10007, 10009, 10037),
                                    (97, 89, 83, 79, 73, 71, 67, 61)])
def test_bit_update_plain_matches_jax_update_dispatch(kind, primes):
    """Flags, n_unique and tables after each batch of a sequence, against
    JAX's _update_dispatch(..., with_event_new=True) for the bit kind,
    with a valid mask that is not a prefix and nvalid < m."""
    m = 4096
    tables = K.init_tables("bit", primes, "cpu")
    n_unique = torch.zeros(1, dtype=torch.int64)
    jt = JK.init_tables("bit", primes)
    jn = jnp.zeros((), jnp.uint64)
    n_new = 0
    for h, valid, nvalid in _batches(len(primes), primes, m, 3, kind):
        live = valid & (np.arange(m) < nvalid)
        jt, jn, _, _, out = jax_pipeline._update_dispatch(
            "bit", primes, jt, jn, jnp.zeros((), jnp.uint64),
            jnp.zeros((), bool), jnp.asarray(h), jnp.asarray(live), False,
            True)
        flags = K.bit_update(primes, tables, n_unique, _t(h), nvalid,
                             torch.from_numpy(valid))
        assert np.array_equal(flags.numpy(), np.asarray(out["event_new"]))
        n_new += int(flags.sum())
        assert int(n_unique) == int(jn) == n_new
        for t, j in zip(tables, jt):
            assert np.array_equal(t.numpy(), np.asarray(j))
    assert 0 < int(n_unique)


def test_bit_update_plain_flags_are_sequential_bitstorage():
    """Per-event flags against a sequential BitStorage::add in Python,
    on a tiny table where most bits collide."""
    primes = (13, 11)
    rng = np.random.default_rng(1)
    h = rng.integers(0, 2**64, 300, dtype=np.uint64)
    tables = K.init_tables("bit", primes, "cpu")
    n_unique = torch.zeros(1, dtype=torch.int64)
    flags = K.bit_update(primes, tables, n_unique, _t(h), 250)
    bits = [set() for _ in primes]
    want = []
    for i, v in enumerate(h.tolist()):
        if i >= 250:
            want.append(False)
            continue
        new = False
        for t, p in enumerate(primes):
            if v % p not in bits[t]:
                bits[t].add(v % p)
                new = True
        want.append(new)
    assert flags.tolist() == want
    assert int(n_unique) == sum(want)
    for t, p in enumerate(primes):
        table = tables[t].numpy()
        got = {b for b in range(p) if table[b // 8] >> (b % 8) & 1}
        assert got == bits[t]


def test_bit_tables_layout():
    primes = (17, 8, 9, 1000003)
    tabs = K.init_tables("bit", primes, "cpu")
    assert K.bit_offsets(primes) == [0, 3, 5, 7]
    assert tabs.flat.shape[0] == K.bit_flat_size(primes) == 125008
    assert [t.shape[0] for t in tabs] == [3, 2, 2, 125001]
    tabs[3][-1] = 7
    assert int(tabs.flat[7 + 125000]) == 7


@pytest.mark.parametrize("size", [1, 6, 7, 8, 13, 14, 15, 64])
def test_bit_occupied_counts_in_slices(size, monkeypatch):
    """Counted a slice at a time; slices of 7 bytes across tables whose
    sizes fall on, before and after a slice boundary."""
    rng = np.random.default_rng(size)
    table = rng.integers(0, 256, size, dtype=np.uint8)
    want = int(np.unpackbits(table).sum())
    monkeypatch.setattr(K, "OCCUPIED_SLICE", 7)
    assert int(K.bit_occupied(torch.from_numpy(table))) == want
    monkeypatch.undo()
    assert int(K.bit_occupied(torch.from_numpy(table))) == want


def test_nodegraph_update_and_occupancy_match_jax():
    rng = np.random.default_rng(5)
    h = rng.integers(0, 2**64, 20000, dtype=np.uint64)
    ng = Nodegraph(20, 1e4, 4, device="cpu")
    jng = JaxNodegraph(20, 1e4, 4)
    for part in np.array_split(h, 3):
        ng._commit_hashes(part)
        jng._commit_hashes(part)
    assert ng.n_unique_kmers() == int(jng.n_unique_kmers())
    assert ng.n_occupied() == int(jng.n_occupied())
    for t, j in zip(ng.get_raw_tables(), jng.get_raw_tables()):
        assert np.array_equal(t, np.asarray(j))


# -- the C++ spacing pass against the Python reference ----------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("density", [2, 10, 40])
def test_tag_spacing_matches_python_reference(seed, density):
    """Random streams of k-mers (many repeats, so tags are met again),
    their new flags and read starts, fed in uneven chunks with tags
    already present: the tags and new counts of the C++ pass equal the
    Python rule's, read by read."""
    rng = np.random.default_rng(seed)
    n = 5000
    hashes = rng.integers(0, 400, n, dtype=np.uint64)
    is_new = (rng.random(n) < 0.4).astype(np.uint8)
    read_start = np.zeros(n, np.uint8)
    read_start[0] = 1
    read_start[rng.integers(1, n, 60)] = 1
    pre = set(int(x) for x in rng.integers(0, 400, 20))

    ref = Nodegraph(20, 100, 1, device="cpu")
    ref._set_tag_density(density)
    ref.all_tags = set(pre)
    starts = list(np.flatnonzero(read_start)) + [n]
    want_new = 0
    for a, b in zip(starts[:-1], starts[1:]):
        nc, since, kmer = ref._tag_spacing_step(
            hashes[a:b], is_new[a:b], density // 2 + 1)
        ref._tag_spacing_tail(since, kmer)
        want_new += nc

    spacing = TagSpacing(pre, density)
    got_new = 0
    cuts = [0] + sorted(rng.integers(1, n, 7).tolist()) + [n]
    for a, b in zip(cuts[:-1], cuts[1:]):
        got_new += spacing.step(hashes[a:b], is_new[a:b], read_start[a:b])
    tags = spacing.end()
    spacing.close()
    assert got_new == want_new == int(is_new.sum())
    assert tags == ref.all_tags
    assert len(tags) > len(pre)


# -- the tagged consume against JAX --------------------------------------------


def _write_reads(path, seed, n=400):
    """Seeded FASTA reads of 0-300 bases with Ns, lowercase bases, reads
    shorter than k and repeats of earlier reads (so k-mers meet tags)."""
    rng = np.random.default_rng(seed)
    seqs = []
    with open(path, "w") as f:
        for i in range(n):
            if seqs and rng.random() < 0.3:
                seq = seqs[int(rng.integers(0, len(seqs)))]
            else:
                length = int(rng.integers(0, 301))
                seq = "".join(rng.choice(list("ACGTACGTACGTacgtN"), length))
            seqs.append(seq)
            f.write(">r%d\n%s\n" % (i, seq))
    return str(path)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    return _write_reads(tmp_path_factory.mktemp("tag") / "reads.fa", 11)


@pytest.fixture(scope="module")
def stamps_head(tmp_path_factory):
    """The first 3,000 reads of data/stamps-reads.fa.gz."""
    path = tmp_path_factory.mktemp("stamps") / "head.fa"
    with open(path, "w") as f:
        for i, rec in enumerate(FastxParser(STAMPS)):
            if i == 3000:
                break
            f.write(">%s\n%s\n" % (rec.name, rec.sequence))
    return str(path)


def _jax_tagged(monkeypatch, engine, path, k, x, n, density=None):
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    j = JaxNodegraph(k, x, n)
    if density:
        j._set_tag_density(density)
    got = j.consume_seqfile_and_tag(path)
    return j, got


def _check_against(ng, got, j, jgot):
    assert got == tuple(int(v) for v in jgot)
    assert ng.all_tags == set(int(t) for t in j.all_tags)
    assert ng.n_unique_kmers() == int(j.n_unique_kmers())
    for t, jt in zip(ng.get_raw_tables(), j.get_raw_tables()):
        assert np.array_equal(t, np.asarray(jt))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("data,k,x,density,chunk", [
    ("genomes", 20, 2.5e7, None, 1000),
    ("reads", 20, 1e5, None, 777),
    ("reads", 4, 1e3, 10, 50),
    ("reads", 32, 1e4, 2, 3000),
    ("stamps", 20, 1e6, None, 1 << 14),
])
def test_consume_seqfile_and_tag_matches_jax(engine, data, k, x, density,
                                             chunk, reads, stamps_head,
                                             monkeypatch):
    """Tags, (reads, new k-mers), n_unique and tables against JAX, with a
    small chunk so that reads straddle chunks; a path (the native
    packer) and a parser (records packed in Python)."""
    path = {"genomes": GENOMES, "reads": reads, "stamps": stamps_head}[data]
    j, jgot = _jax_tagged(monkeypatch, engine, path, k, x, 4, density)
    monkeypatch.setattr(pipeline, "DENSE_CHUNK", chunk)
    for source in (path, FastxParser(path)):
        ng = Nodegraph(k, x, 4, device="cpu")
        if density:
            ng._set_tag_density(density)
        got = ng.consume_seqfile_and_tag(source)
        _check_against(ng, got, j, jgot)
    assert ng.n_tags() > 0


def test_consume_seqfile_and_tag_keeps_existing_tags(reads, monkeypatch):
    """A second file tagged on top of the first, as load-graph does with
    several inputs, against JAX (device engine)."""
    monkeypatch.setenv("KHMER_TPU_ENGINE", "device")
    ng = Nodegraph(20, 1e5, 4, device="cpu")
    j = JaxNodegraph(20, 1e5, 4)
    monkeypatch.setattr(pipeline, "DENSE_CHUNK", 500)
    for path in (reads, GENOMES):
        got = ng.consume_seqfile_and_tag(path)
        jgot = j.consume_seqfile_and_tag(path)
    _check_against(ng, got, j, jgot)


def test_dense_hashes_mark_read_starts(reads):
    k = 20
    for codes, offs, lens in read_blocks(reads):
        hashes, start = dense_hashes(codes, offs, lens, k)
        nwin = np.maximum(lens - k + 1, 0)
        assert len(hashes) == nwin.sum() == len(start)
        assert start.sum() == (nwin > 0).sum()


def test_tag_api():
    ng = Nodegraph(20, 1e4, 2, device="cpu")
    kmer = "ACGTACGTACGTACGTACGA"
    ng.add_tag(kmer)
    ng.add_tag(ng.hash("TTTTTCCCCCGGGGGAAAAA"))
    assert ng.n_tags() == 2
    assert ng.get_tags_for_sequence("C" + kmer + "G") == [ng.hash(kmer)]
    assert sorted(ng.get_tagset()) == sorted(
        ng.reverse_hash(t) for t in ng.all_tags)
    assert ng._get_tag_density() == 40
    with pytest.raises(ValueError):
        ng._set_tag_density(3)


# -- OXLI type 3 -------------------------------------------------------------


def test_tagset_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    tags = set(int(t) for t in rng.integers(0, 2**63, 500))
    tags.add(2**64 - 1)
    for name in ("a.tagset", "a.tagset.gz"):
        ours, theirs = tmp_path / ("p" + name), tmp_path / ("j" + name)
        oxli_io.save_tagset(str(ours), 20, tags, 40)
        jax_oxli.save_tagset(str(theirs), 20, tags, 40)
        if not name.endswith(".gz"):
            assert ours.read_bytes() == theirs.read_bytes()
        assert oxli_io.load_tagset(str(ours), 20) == (tags, 40)
        assert oxli_io.load_tagset(str(theirs)) == (tags, 40)
    with pytest.raises(OSError, match="k-mer size"):
        oxli_io.load_tagset(str(tmp_path / "pa.tagset"), 21)
    ng = Nodegraph(20, 1e3, 1, device="cpu")
    ng.save(str(tmp_path / "g.ng"))
    with pytest.raises(OSError, match="type"):
        oxli_io.load_tagset(str(tmp_path / "g.ng"))


def test_nodegraph_save_load_round_trip(tmp_path, reads):
    ng = Nodegraph(20, 1e5, 4, device="cpu")
    ng.consume_seqfile_and_tag(reads)
    ng.save(str(tmp_path / "g.ng"))
    ng.save_tagset(str(tmp_path / "g.tagset"))
    back = Nodegraph.load(str(tmp_path / "g.ng"), device="cpu")
    for a, b in zip(ng.get_raw_tables(), back.get_raw_tables()):
        assert np.array_equal(a, b)
    assert back.n_occupied() == ng.n_occupied()
    back.load_tagset(str(tmp_path / "g.tagset"))
    assert back.all_tags == ng.all_tags
    j = JaxNodegraph.load(str(tmp_path / "g.ng"))
    j.load_tagset(str(tmp_path / "g.tagset"))
    assert set(int(t) for t in j.all_tags) == ng.all_tags


# -- the load-graph CLI ------------------------------------------------------


def _run(module, args, cwd):
    """A CLI's main() in this process, in `cwd`: (status, stderr)."""
    mod = importlib.import_module(module)
    saved = sys.argv, sys.stderr, os.getcwd()
    err = io.StringIO()
    sys.argv = [module] + args
    sys.stderr = err
    os.chdir(cwd)
    try:
        try:
            mod.main()
            status = 0
        except SystemExit as exc:
            status = exc.code or 0
    finally:
        sys.argv, sys.stderr = saved[:2]
        os.chdir(saved[2])
    return status, err.getvalue()


def _body(err):
    """stderr without the version banner (it names the package)."""
    return [line for line in err.splitlines()
            if not line.startswith("||")]


LG_CASES = {
    "genomes": (["-k", "20", "-x", "2.5e7", "-N", "4"], ["{genomes}"]),
    "genomes-n": (["-k", "20", "-x", "2.5e7", "-N", "4", "-n"],
                  ["{genomes}"]),
    "reads-two": (["-k", "17", "-x", "2e5", "-N", "3", "-T", "4"],
                  ["{reads}", "{genomes}"]),
    "stamps": (["-k", "20", "-x", "1e6", "-N", "4"], ["{stamps}"]),
    "stamps-M": (["-k", "20", "-M", "2e6"], ["{stamps}"]),
    "too-small": (["-k", "20", "-x", "1e3", "-N", "2"], ["{stamps}"]),
    "too-small-f": (["-k", "20", "-x", "1e3", "-N", "2", "-f"],
                    ["{stamps}"]),
}


@pytest.mark.parametrize("name", list(LG_CASES))
@pytest.mark.parametrize("engine", ENGINES)
def test_load_graph_cli_matches_jax(name, engine, reads, stamps_head,
                                    tmp_path, monkeypatch):
    """.ng, .tagset and .info bytes, the exit status and stderr (without
    the banner) of the port's load-graph against the JAX CLI's."""
    monkeypatch.setenv("KHMER_TPU_ENGINE", engine)
    flags, inputs = LG_CASES[name]
    inputs = [a.format(genomes=GENOMES, reads=reads, stamps=stamps_head)
              for a in inputs]
    got = {}
    for side, module in (("port", "khmer_tpu_torch.cli.load_graph"),
                         ("jax", "khmer_tpu.cli.load_graph")):
        d = tmp_path / side
        d.mkdir()
        args = flags + ["out.ng"] + inputs
        if side == "port":
            args += ["--device", "cpu"]
        status, err = _run(module, args, d)
        files = {}
        for ext in ("", ".tagset", ".info"):
            p = d / ("out.ng" + ext)
            files[ext] = p.read_bytes() if p.exists() else None
        got[side] = (status, _body(err), files)
    assert got["port"] == got["jax"]
    status, body, files = got["port"]
    if name == "too-small":
        assert status == 1
    else:
        assert status == 0
        assert files[".info"].startswith(b"%d unique k-mers" % int(
            [line for line in body if line.startswith("Total number")][0]
            .split()[-1]))
    assert (files[".tagset"] is None) == (name == "genomes-n")


def test_load_graph_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _run("khmer_tpu_torch.cli.load_graph",
             ["-k", "20", "out.ng", GENOMES], tmp_path)
