"""The exact byte layout of khmer_tpu_torch against the JAX package: the
plain update with its bigcount report against ``make_update("byte", ...,
with_bigcount=True)`` on the cases of tests/test_v2_update.py and on
tables small enough that JAX takes its image and sort paths, the count
gather against ``make_get``, and the Countgraph state (tables, n_unique,
bigcount map, n_occupied) carried across by ``from_numpy_state``.
Integer state: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu import Countgraph as JaxCountgraph
from khmer_tpu.core import sketch_kernels as JK
from khmer_tpu_torch import BlockedCountgraph, Countgraph, Nodegraph
from khmer_tpu_torch import load_countgraph
from khmer_tpu_torch.core import sketch_kernels as TK

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

K = 20


def _case(name):
    """(primes, initial tables, [(hashes u64 [M], valid bool [M]), ...],
    the JAX path it exercises) of a named case."""
    if name.startswith("random-"):
        # test_v2_random_batches_match_oracle: a tiny hash universe
        rng = np.random.default_rng(int(name[-1]))
        primes = (997, 991, 983)
        batches = [(rng.integers(0, 300, 512).astype(np.uint64) * 977,
                    rng.random(512) < 0.8) for _ in range(4)]
        return primes, None, batches, "v2"
    if name == "cross-hash-collisions":
        # test_v2_cross_hash_bin_collisions: h and h + 101*103*107 share
        # a bin in every table
        primes = (101, 103, 107)
        w = 101 * 103 * 107
        base = np.asarray([5, 17, 42, 5 + w, 17 + w, 42, 99, 42 + 2 * w],
                          np.uint64)
        h = np.zeros(256, np.uint64)
        h[:len(base)] = base
        return primes, None, [(h, np.arange(256) < len(base))], "v2"
    if name == "saturation-bigcount":
        # test_v2_saturation_and_bigcount_triggers
        primes = (53, 59, 61)
        rng = np.random.default_rng(7)
        tables = [np.full(p, 254, np.uint8) for p in primes]
        h = rng.integers(0, 40, 1024).astype(np.uint64)
        return primes, tables, [(h, np.ones(1024, bool))], "v2"
    if name == "v2-overflow":
        # test_v2_overflow_flag_trips: the batch that trips v2's collision
        # budget; JAX serves it exactly on its image path
        p = 140009
        n = np.arange(8192, dtype=np.uint64)
        return (p,), None, [(n * p + n % 7, np.ones(8192, bool))], "image"
    rng = np.random.default_rng(len(name))
    primes = (9973, 9967, 9949) if name == "image" else (7919, 7907)
    pool = rng.integers(0, 2**64, 3000, dtype=np.uint64)
    pool[:500] |= np.uint64(1 << 63)
    pool[500] = 0  # hash 0 is the all-A k-mer: a real event
    hot = pool[:12]
    batches = []
    for c in range(4):
        h = pool[rng.integers(0, 3000, 8192)]
        mask = rng.random(8192) < 0.25
        h[mask] = hot[rng.integers(0, 12, int(mask.sum()))]
        h[::97] = hot[c]          # driven past 255 within the chunk
        nvalid = 8192 - 501 * c   # a zero-padded tail
        h[nvalid:] = 0
        batches.append((h, np.arange(8192) < nvalid))
    return primes, None, batches, name


CASES = ["random-0", "random-1", "random-2", "cross-hash-collisions",
         "saturation-bigcount", "v2-overflow", "image", "sort"]


def _jax_path(primes, m):
    if JK.use_v2_path("byte", primes, m):
        return "v2"
    return "image" if JK.use_image_path("byte", primes) else "sort"


@pytest.mark.parametrize("name", CASES)
def test_byte_update_matches_jax_make_update(name, monkeypatch):
    primes, tables, batches, path = _case(name)
    if name == "v2-overflow":
        monkeypatch.setenv("KHMER_TPU_NO_V2", "1")
    if name == "sort":
        monkeypatch.setenv("KHMER_TPU_NO_V2", "1")
        monkeypatch.setattr(JK, "IMAGE_PATH_MAX_PRIME", 0)
    assert _jax_path(primes, batches[0][0].shape[0]) == path
    if tables is None:
        tables = [np.zeros(p, np.uint8) for p in primes]
    jcg = JaxCountgraph(K, 1, 1, primes=primes)
    jcg.set_use_bigcount(True)
    jcg.tables = tuple(jnp.asarray(t) for t in tables)
    cg = Countgraph.from_numpy_state(K, primes, tables, 0, 0, device="cpu",
                                     use_bigcount=True)
    update = JK.make_update("byte", primes, with_bigcount=True)
    for hashes, valid in batches:
        new_tables, out = update(jcg.tables, jcg._n_unique,
                                 jnp.asarray(hashes), jnp.asarray(valid))
        jcg.tables = new_tables
        jcg._n_unique = out["n_unique"]
        assert not bool(out.get("v2_overflow", False))
        jcg._absorb_saturation(out)
        # the port takes the valid events as a prefix, in stream order
        live = hashes[valid]
        padded = np.zeros(len(hashes), np.uint64)
        padded[:len(live)] = live
        cg._update(torch.from_numpy(padded.view(np.int64)), len(live))
        for got, want in zip(cg.get_raw_tables(), jcg.get_raw_tables()):
            assert np.array_equal(got, want)
        assert cg.n_unique_kmers() == jcg.n_unique_kmers()
        assert cg._bigcounts == jcg._bigcounts
    if name in ("saturation-bigcount", "image", "sort"):
        assert cg._bigcounts  # the case reaches bigcount
    # the same state carried across from the JAX sketch
    carried = Countgraph.from_numpy_state(
        K, primes, jcg.get_raw_tables(), jcg.n_unique_kmers(), 0,
        device="cpu", bigcounts=jcg._bigcounts, use_bigcount=True)
    assert carried.n_occupied() == cg.n_occupied() == jcg.n_occupied()
    assert carried._bigcounts == cg._bigcounts
    query = np.concatenate([b[0] for b in batches] + [
        np.random.default_rng(1).integers(0, 2**64, 500, dtype=np.uint64)])
    want = jcg.get_counts_for_hashes(query)
    assert np.array_equal(cg.get_counts_for_hashes(query), want)
    assert np.array_equal(carried.get_counts_for_hashes(query), want)


@pytest.mark.parametrize("name", ["image", "saturation-bigcount"])
def test_byte_update_plain_report_and_gather(name):
    """The plain functions themselves: the report's per-hash triggers
    equal the sequential model's, and the gather equals make_get."""
    primes, tables, batches, _ = _case(name)
    if tables is None:
        tables = [np.zeros(p, np.uint8) for p in primes]
    flat = torch.zeros(TK.byte_flat_size(primes), dtype=torch.uint8)
    views = TK.ByteTables(flat, primes)
    for v, t in zip(views, tables):
        v.copy_(torch.from_numpy(t))
    seq = [t.astype(np.int64) for t in tables]
    n_unique = torch.zeros(1, dtype=torch.int64)
    want_nu = 0
    for hashes, valid in batches:
        live = hashes[valid]
        want_trig = {}
        for h in live:
            bins = [int(h % np.uint64(p)) for p in primes]
            want_nu += any(s[b] == 0 for s, b in zip(seq, bins))
            if all(s[b] == TK.MAX_KCOUNT for s, b in zip(seq, bins)):
                want_trig[int(h)] = want_trig.get(int(h), 0) + 1
            for s, b in zip(seq, bins):
                s[b] = min(s[b] + 1, TK.MAX_KCOUNT)
        report = TK.byte_update_plain(
            primes, flat, n_unique, torch.from_numpy(live.view(np.int64)),
            len(live), with_bigcount=True)
        cand_hash, cand_old, n_cand = report
        assert int(n_cand[0]) == cand_hash.shape[0]
        got_trig = TK.bigcount_triggers(cand_hash.numpy().view(np.uint64),
                                        cand_old.numpy())
        assert got_trig == want_trig
        assert int(n_unique) == want_nu
        for v, s in zip(views, seq):
            assert np.array_equal(v.numpy(), s.astype(np.uint8))
    query = np.concatenate([b[0] for b in batches])
    want = np.asarray(JK.make_get("byte", primes)(
        tuple(jnp.asarray(s.astype(np.uint8)) for s in seq),
        jnp.asarray(query)))
    got = TK.byte_gather(primes, flat,
                         torch.from_numpy(query.view(np.int64)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert int(TK.byte_occupied(views[0])) == int(JK.byte_occupied(
        jnp.asarray(seq[0].astype(np.uint8))))


def test_byte_tables_are_prime_views_of_a_padded_buffer():
    primes = (13, 11, 7)
    tabs = TK.init_tables("byte", primes, "cpu")
    assert [t.shape[0] for t in tabs] == list(primes)
    assert tabs.flat.shape[0] == 32 and tabs.flat.shape[0] % 4 == 0
    tabs[1][3] = 9
    assert int(tabs.flat[13 + 3]) == 9


def test_the_cuda_wrappers_refuse_cpu_tensors():
    primes = (13, 11)
    flat = torch.zeros(TK.byte_flat_size(primes), dtype=torch.uint8)
    h = torch.zeros(4, dtype=torch.int64)
    scratch = torch.empty(TK.update_plan(4, len(primes))[2],
                          dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        TK.byte_update_cuda(primes, flat, torch.zeros(1, dtype=torch.int64),
                            h, 4, with_bigcount=True, scratch=scratch)
    with pytest.raises(ValueError, match="CUDA"):
        TK.byte_gather_cuda(primes, flat, h)
    with pytest.raises(ValueError, match="CUDA"):
        TK.histogram_add_cuda(torch.zeros(8, dtype=torch.int64), h)


@pytest.mark.parametrize("make", [
    lambda: Nodegraph(20, 1e3, 1),
    lambda: Countgraph(20, 1e3, 2),
    lambda: BlockedCountgraph(20, 1e4, 4),
    lambda: Countgraph.from_numpy_state(20, (13,), [np.zeros(13, np.uint8)],
                                        0, 0),
], ids=["Nodegraph", "Countgraph", "BlockedCountgraph", "from_numpy_state"])
def test_sketches_default_to_the_card(make):
    """With no device named, a sketch is made on the card; with none
    present that raises and never falls back to the CPU."""
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_load_countgraph_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "x.ct")
    Countgraph(20, 1e3, 2, device="cpu").save(path)
    if torch.cuda.is_available():
        assert load_countgraph(path).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        load_countgraph(path)
    assert load_countgraph(path, device="cpu").hashsizes() == [997, 991]
