"""Kernel R's and Q's rows modes and Q's mask on the CPU, against the JAX
package, exactly: nibble_pertable_rows_plain against JAX's
make_pertable_counts on the nibble kind (hashes, per-table counters and
flat nibble indices on every valid window; the fill on the others),
nibble_row_counts_plain against JAX's make_hash_batch then
_gather_counts, on the row cases of scripts/nibble_cases.py that fit the
CPU (k 1, 20 and 32; rows of L % 16 != 0 with reads shorter than k and
empty rows; tables that share 32-bit words; a read over 4,096 bases);
nibble_gather_plain under masks; SeqWindow on a SmallCountgraph, whose
rows mode numbers (table, counter) pairs by flat nibble index, against
JAX's SeqWindow on a window whose reads touch one pair twice; and the
CUDA wrappers' refusals of CPU tensors and wrong dtypes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu import SmallCountgraph as JaxSmallCountgraph
from khmer_tpu.core import diginorm as jax_diginorm
from khmer_tpu.core import pipeline as jax_pipeline
from khmer_tpu.core import sketch_kernels as JK
from khmer_tpu_torch import SmallCountgraph
from khmer_tpu_torch.core import diginorm
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops import hashing as H
from khmer_tpu_torch.scripts import nibble_cases

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")
# the row cases a CPU test takes (the million-code row and the 4 GB
# window run on the card: tests/test_torch_gpu_kernels.py)
CPU_ROW_CASES = [name for name, (_, near, _, rows)
                 in nibble_cases.ROW_CASES.items()
                 if near < 1e9 and rows != "million"]


def _views(flat, primes):
    """The T nibble tables of a flat buffer, as JAX holds them."""
    return tuple(jnp.asarray(flat[o:o + K.nibble_table_bytes(p)].numpy())
                 for o, p in zip(K.nibble_offsets(primes), primes))


@pytest.fixture(scope="module")
def jax_rows():
    """name -> (the case, JAX's make_pertable_counts (hashes, per, valid)
    and make_hash_batch + _gather_counts counts) of each CPU row case,
    each run once for the module."""
    out = {}
    for name in CPU_ROW_CASES:
        primes, flat, codes, lengths, k = nibble_cases.row_case(name, CPU)
        tables = _views(flat, primes)
        c, n = jnp.asarray(codes.numpy()), jnp.asarray(lengths.numpy())
        jh, jper, jvalid = jax_diginorm.make_pertable_counts(
            "nibble", primes, k, "twobit")(tables, c, n)
        canon, bvalid = jax_pipeline.make_hash_batch(k, "twobit")(c, n)
        counts = JK._gather_counts("nibble", primes, tables, canon)
        assert (np.asarray(bvalid) == np.asarray(jvalid)).all()
        out[name] = ((primes, flat, codes, lengths, k),
                     (np.asarray(jh), np.asarray(jper), np.asarray(jvalid)),
                     np.asarray(counts))
    return out


@pytest.mark.parametrize("name", CPU_ROW_CASES)
def test_pertable_rows_plain_matches_jax(jax_rows, name):
    (primes, flat, codes, lengths, k), (jh, jper, valid), _ = jax_rows[name]
    hashes, counters, index = K.nibble_pertable_rows_plain(
        primes, flat, codes, lengths, k)
    T = len(primes)
    B, W = valid.shape
    assert hashes.dtype == torch.int64 and hashes.shape == (B, W)
    assert counters.dtype == torch.uint8 and counters.shape == (T, B, W)
    assert index.dtype == torch.int64 and index.shape == (T, B, W)
    assert 0 < valid.sum() < valid.size
    h = hashes.numpy().view(np.uint64)
    assert (h[valid] == jh[valid]).all()
    assert (counters.numpy()[:, valid] == jper[:, valid]).all()
    for t, (off, p) in enumerate(zip(K.nibble_offsets(primes), primes)):
        want = (jh[valid] % np.uint64(p) + np.uint64(2 * off)).astype(
            np.int64)
        assert (index.numpy()[t][valid] == want).all()
    # the fill past each read's end
    assert (h[~valid] == 0).all()
    assert (counters.numpy()[:, ~valid] == 0).all()
    assert (index.numpy()[:, ~valid] == -1).all()
    # the dispatcher takes the plain version for CPU tensors
    got = K.nibble_pertable_rows(primes, flat, codes, lengths, k)
    for a, b in zip(got, (hashes, counters, index)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", CPU_ROW_CASES)
def test_row_counts_plain_matches_jax(jax_rows, name):
    (primes, flat, codes, lengths, k), (_, _, valid), counts = \
        jax_rows[name]
    got = K.nibble_row_counts_plain(primes, flat, codes, lengths, k)
    assert got.dtype == torch.uint8 and got.shape == valid.shape
    assert (got.numpy()[valid] == counts[valid]).all()
    assert (got.numpy()[~valid] == 0).all()
    assert torch.equal(K.nibble_row_counts(primes, flat, codes, lengths, k),
                       got)


def test_row_cases_cover_the_edges():
    """The CPU row cases hold k 1, 20 and 32, a row length that is no
    multiple of 16, reads shorter than k, empty rows, a read over 4,096
    bases and tables that start inside a 32-bit word."""
    ks, odd_rows, short, empty, long_read, mid_word = (set(), False, False,
                                                       False, False, False)
    for name in CPU_ROW_CASES:
        primes, _, codes, lengths, k = nibble_cases.row_case(name, CPU)
        ks.add(k)
        odd_rows |= codes.shape[1] % 16 != 0
        short |= bool(((lengths > 0) & (lengths < k)).any())
        empty |= bool((lengths == 0).any())
        long_read |= bool((lengths > 4096).any())
        mid_word |= any(o % 4 for o in K.nibble_offsets(primes))
    assert {1, 20, 32} <= ks
    assert odd_rows and short and empty and long_read and mid_word


@pytest.mark.parametrize("which", ["random", "all-false", "all-true"])
def test_nibble_gather_mask(which):
    """Masked-off hashes count 0; the others give the unmasked gather,
    which is JAX's _gather_counts."""
    primes = nibble_cases.case_primes("tiny-odd-primes") + tuple(
        K.get_n_primes_near_x(2, 2e5))
    rng = np.random.default_rng(23)
    flat = torch.from_numpy(rng.integers(
        0, 256, K.nibble_flat_size(primes)).astype(np.uint8))
    h = rng.integers(0, 2**64, 5000, dtype=np.uint64)
    ht = torch.from_numpy(h.view(np.int64).copy())
    mask = {"random": torch.from_numpy(rng.random(5000) < 0.4),
            "all-false": torch.zeros(5000, dtype=torch.bool),
            "all-true": torch.ones(5000, dtype=torch.bool)}[which]
    whole = K.nibble_gather_plain(primes, flat, ht)
    assert (whole.numpy() == np.asarray(JK._gather_counts(
        "nibble", primes, _views(flat, primes), jnp.asarray(h)))).all()
    got = K.nibble_gather_plain(primes, flat, ht, mask)
    assert got.dtype == torch.int32
    assert torch.equal(got[mask], whole[mask])
    assert (got[~mask] == 0).all()
    assert torch.equal(K.nibble_gather(primes, flat, ht, mask), got)
    # any shape, as the dispatcher takes it
    assert torch.equal(K.nibble_gather(primes, flat, ht.reshape(50, 100),
                                       mask.reshape(50, 100)),
                       got.reshape(50, 100))


def _window_graphs():
    """A SmallCountgraph on the CPU and JAX's, over the same tables of
    random nibbles (k 20, four tables near 1e6), and a window of reads:
    ones whose k-mers repeat (a period of 8, so one (table, counter) pair
    is touched many times over), random reads, one shorter than k and an
    empty one (JAX's SeqWindow takes no read over 4,096 bases: ROADMAP
    section 3)."""
    k = 20
    primes = tuple(K.get_n_primes_near_x(4, 1e6))
    rng = np.random.default_rng(7)
    tables = [rng.integers(0, 256, K.nibble_table_bytes(p)).astype(np.uint8)
              for p in primes]
    pg = SmallCountgraph.from_numpy_state(k, primes, tables, 0, 0,
                                          device="cpu")
    jg = JaxSmallCountgraph(k, 1, 1, primes=primes)
    jg.tables = tuple(jnp.asarray(t) for t in tables)

    def rand(n):
        return "".join("ACGT"[c] for c in rng.integers(0, 4, n))

    seqs = ["ACGTTGCA" * 12, rand(100), rand(90) + "ACGTTGCA" * 4,
            "ACG", "", rand(100), "GATTACAG" * 10, rand(300)]
    seqs += [rand(n) for n in rng.integers(20, 130, 30)]
    return k, pg, jg, seqs


def test_seq_window_repeats_match_jax(monkeypatch):
    """SeqWindow on nibble tables through kernel R's rows mode: the reads
    that touch one pair twice are found, and every read's counts as the
    window walks (consuming every other read) and the tables after the
    flush equal JAX's SeqWindow; no torch hash of the windows and no
    per-table umod runs in the port's step."""
    k, pg, jg, seqs = _window_graphs()

    def refuse(*args, **kwargs):
        raise AssertionError("the nibble window runs no torch hash or umod")

    monkeypatch.setattr(diginorm, "umod", refuse)
    monkeypatch.setattr(H, "hash_windows", refuse)
    win = diginorm.SeqWindow(pg, seqs)
    monkeypatch.undo()
    jwin = jax_diginorm.SeqWindow(jg, seqs)
    repeats = [d[4] for d in win._data]
    assert repeats[0] and repeats[6] and not repeats[1]
    for i in range(len(seqs)):
        got, want = win.counts(i), jwin.counts(i)
        assert got.dtype == np.int32
        assert got.shape == want.shape and (got == want).all(), i
        if i % 2 == 0:
            win.consume(i)
            jwin.consume(i)
    for i in range(len(seqs)):
        assert (win.counts(i) == jwin.counts(i)).all(), i
    win.flush()
    jwin.flush()
    for t, j in zip(pg.tables, jg.tables):
        assert (t.numpy() == np.asarray(j)).all()


def test_rows_cuda_wrappers_refuse_cpu_tensors_and_wrong_dtypes():
    primes, flat, codes, lengths, k = nibble_cases.row_case("k20-odd-rows",
                                                            CPU)
    h = torch.zeros(8, dtype=torch.int64)
    for fn in (K.nibble_pertable_rows_cuda, K.nibble_row_counts_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(primes, flat, codes, lengths, k)
        with pytest.raises(ValueError, match="uint8"):
            fn(primes, flat, codes.to(torch.int64), lengths, k)
        with pytest.raises(ValueError, match="int32"):
            fn(primes, flat, codes, lengths.to(torch.int64), k)
        with pytest.raises(ValueError, match="hold no"):
            fn(primes, flat, codes, lengths, 33)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.nibble_gather_cuda(primes, flat, h, torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError, match="bool"):
        K.nibble_gather_cuda(primes, flat, h, torch.ones(8,
                                                         dtype=torch.uint8))
    with pytest.raises(ValueError, match="bool"):
        K.nibble_gather_cuda(primes, flat, h, torch.ones(7, dtype=torch.bool))
