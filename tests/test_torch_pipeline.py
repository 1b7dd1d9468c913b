"""The port's counting pipeline and histogram against the JAX package, on
the first reads of data/25k.fq.gz with small tables. Equality is exact."""

import gzip
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu import Nodegraph as JaxNodegraph
from khmer_tpu.core import pipeline as jax_pipeline
from khmer_tpu.core.blocked import BlockedCountgraph as JaxBlocked
from khmer_tpu.io import native as jax_native
from khmer_tpu.io.fastx import FastxParser as JaxParser
from khmer_tpu_torch.core import blocked as TB
from khmer_tpu_torch.core import pipeline
from khmer_tpu_torch.core import sketch
from khmer_tpu_torch.io import native
from khmer_tpu_torch.io.fastx import FastxParser
from khmer_tpu_torch.ops import hashing as H

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "25k.fq.gz")
K = 20


@pytest.fixture(scope="module")
def reads_fq(tmp_path_factory):
    """The first 3000 reads of data/25k.fq.gz as a plain FASTQ file."""
    path = str(tmp_path_factory.mktemp("reads") / "head3000.fq")
    with gzip.open(DATA, "rt") as src, open(path, "w") as dst:
        dst.writelines(itertools.islice(src, 4 * 3000))
    return path


def _seqs(path):
    return [r.cleaned_seq for r in FastxParser(path)]


def test_dense_hasher_chunks_match_jax(reads_fq):
    """Per-read adds and native blocks give the JAX chunks; the tail has
    the same valid prefix (the port pads it to the full chunk size)."""
    kw = dict(chunk=4096, pack_chunk=8192)
    for feed in ("reads", "blocks"):
        mine = pipeline.DenseHasher(K, "twobit", **kw)
        ref = jax_pipeline.DenseHasher(K, "twobit", **kw)
        got, want = [], []
        if feed == "reads":
            for seq in _seqs(reads_fq):
                got += mine.add(seq)
                want += ref.add(seq)
        else:
            for (c, m, _), (jc, jm, _) in zip(native.pack_blocks(reads_fq),
                                              jax_native.pack_blocks(reads_fq)):
                got += mine.add_block(c, m[:, 0], m[:, 1])
                want += ref.add_block(jc, jm[:, 0], jm[:, 1])
        got += mine.flush()
        want += ref.flush()
        assert len(got) == len(want) > 10
        for (h, n), (jh, jn) in zip(got, want):
            assert n == jn and len(h) == 4096
            assert (h[:n] == jh[:jn]).all()


@pytest.fixture(scope="module")
def jax_sketch(reads_fq):
    cg = JaxBlocked(K, 1e5, 4)
    counts = cg.consume_seqfile(JaxParser(reads_fq))
    return cg, counts


@pytest.mark.parametrize("source", ["path", "parser"])
def test_consume_seqfile_matches_jax(reads_fq, jax_sketch, source):
    """The native-parser path (a file name) and the record path (a parser,
    as the CLI passes) both give JAX's table, n_unique and n_occupied."""
    jcg, jcounts = jax_sketch
    cg = TB.BlockedCountgraph(K, 1e5, 4, device="cpu")
    counts = cg.consume_seqfile(
        reads_fq if source == "path" else FastxParser(reads_fq))
    assert counts == jcounts == (3000, counts[1])
    assert cg.nblocks == jcg.nblocks
    assert (cg.tables[0].numpy() == np.asarray(jcg.tables[0])).all()
    assert cg.n_unique_kmers() == jcg.n_unique_kmers()
    assert cg.n_occupied() == jcg.n_occupied()
    seq = _seqs(reads_fq)[5]
    assert cg.get(seq[:K]) == jcg.get(seq[:K])


def test_abundance_distribution_matches_jax(reads_fq, jax_sketch):
    jcg, _ = jax_sketch
    jtrack = JaxNodegraph(K, 1, 1, primes=jcg.hashsizes())
    want = jcg.abundance_distribution(reads_fq, jtrack)
    cg = TB.from_numpy_state(K, np.asarray(jcg.tables[0]),
                             jcg.n_unique_kmers(), 0, "cpu")
    track = sketch.Nodegraph(K, 1, 1, primes=cg.hashsizes(), device="cpu")
    got = cg.abundance_distribution(FastxParser(reads_fq), track)
    assert len(got) == len(want) == 65536
    assert got == want and sum(got) > 0
    for t, jt in zip(track.tables, jtrack.tables):
        assert (t.numpy() == np.asarray(jt)).all()


def test_from_numpy_state_carries_a_jax_sketch(reads_fq, jax_sketch):
    """State taken from JAX, then updated further in both packages, stays
    equal."""
    jcg, _ = jax_sketch
    cg = TB.from_numpy_state(K, np.asarray(jcg.tables[0]),
                             jcg.n_unique_kmers(), 7, "cpu")
    assert cg.n_unique_kmers() == jcg.n_unique_kmers()
    assert cg.n_occupied() == jcg.n_occupied() + 7
    seqs = _seqs(reads_fq)[:40]
    jnext = JaxBlocked(K, 1, 1, primes=(jcg.nblocks,))
    jnext.tables = (jnp.asarray(np.asarray(jcg.tables[0])),)
    jnext._n_unique = jnp.uint64(jcg.n_unique_kmers())
    for seq in seqs:
        cg._commit_hashes(H.host_hash_windows(H.encode_dna(seq), K))
        jnext.consume(seq)
    assert (cg.tables[0].numpy() == np.asarray(jnext.tables[0])).all()
    assert cg.n_unique_kmers() == jnext.n_unique_kmers()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nodegraph_counts_match_jax(seed):
    """The bit-table update (sort dedup, per-bin winners) and its state
    carried across with from_numpy_state."""
    rng = np.random.default_rng(seed)
    primes = (1009, 1013, 1019)
    pool = rng.integers(0, 2**64, 700, dtype=np.uint64)
    jng = JaxNodegraph(K, 1, 1, primes=primes)
    ng = sketch.Nodegraph(K, 1, 1, primes=primes, device="cpu")
    for _ in range(3):
        h = pool[rng.integers(0, 700, 1500)]
        jng._commit_hashes(h)
        ng._commit_hashes(h)
        assert ng.n_unique_kmers() == jng.n_unique_kmers()
        for t, jt in zip(ng.tables, jng.tables):
            assert (t.numpy() == np.asarray(jt)).all()
    q = np.concatenate([pool, rng.integers(0, 2**64, 300, dtype=np.uint64)])
    assert (ng.get_counts_for_hashes(q) == jng.get_counts_for_hashes(q)).all()
    assert ng.n_occupied() == jng.n_occupied()
    back = sketch.from_numpy_state(
        K, primes, [np.asarray(t) for t in jng.tables],
        jng.n_unique_kmers(), 0, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.tables, ng.tables))
    assert back.n_unique_kmers() == ng.n_unique_kmers()
