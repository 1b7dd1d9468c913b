"""Kernel H's tiling and the plain mirror of its split, on the CPU.

sketch_kernels.read_plan (the rows a tile, the windows a segment and the
shared bytes of csrc/read_counts.cu) is held to its invariants on many
(L, k), and read_blocks (the kernel's grid) to cover every (row, window)
item exactly once. read_split_plain, which takes each block's windows at
or above at_least and first window below cutoff and combines a row's
blocks as the kernel does, is held equal to read_counts_plain on the rows
of scripts/trim_cases.py COUNT_CASES, and to the JAX package's
counts_for_records followed by trim_pos_from_counts and
median_at_least_from_counts on seeded reads: reads over several segments
whose only bad window lies in a later one, a bad window 0 alone, reads of
0, 1 and 2 windows, k = 1, 20 and 32, cutoff and at_least of 0, equal and
in either order, and thresholds above 255 with a bigcount map. JAX runs on
the CPU, as its own tests run it; the kernel itself runs on the card
(tests/test_torch_gpu_kernels.py).
"""

import numpy as np
import pytest
import torch

import khmer_tpu
from khmer_tpu.core import pipeline as jax_pipeline
from khmer_tpu.io.fastx import Record as JaxRecord
from khmer_tpu.utils import trimming as jax_trimming
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.diginorm_scan import pack_reads
from khmer_tpu_torch.core.sketch import Countgraph
from khmer_tpu_torch.scripts import trim_cases

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

LENGTHS = (1, 2, 31, 32, 33, 64, 77, 128, 133, 1000, 1023, 1024, 1025,
           1056, 2048, 4096, 5003, 15000, 1_000_000)


@pytest.mark.parametrize("k", [1, 2, 19, 20, 31, 32])
def test_read_plan_invariants(k):
    """Shared bytes within the limit, rows a tile in [1, READ_MAX_ROWS],
    segments of a multiple of 32 windows that cover a row's L - k + 1
    windows with fewer than one segment to spare; rows of up to READ_SEG
    windows in one segment (one launch, no scratch), longer rows over
    several; and the items a block holds near READ_ITEMS."""
    for extra in LENGTHS:
        L = k - 1 + extra
        W = L - k + 1
        plan = K.read_plan(L, k)
        rows, seg, segs = plan["rows"], plan["seg"], plan["segs"]
        assert plan["smem"] == rows * (16 * (seg // 32 + 1) + seg)
        assert plan["smem"] <= K.READ_SMEM_LIMIT
        assert 1 <= rows <= K.READ_MAX_ROWS
        assert seg % 32 == 0 and 32 <= seg <= K.READ_SEG
        assert (segs - 1) * seg < W <= segs * seg
        assert (segs == 1) == (W <= K.READ_SEG)
        assert seg < W + 32
        assert rows * seg <= max(K.READ_ITEMS, seg)
        assert rows == K.READ_MAX_ROWS or rows * seg > K.READ_ITEMS - seg


def test_read_plan_refuses_rows_without_a_kmer():
    for L, k in ((19, 20), (10, 0), (40, 33)):
        with pytest.raises(ValueError):
            K.read_plan(L, k)


@pytest.mark.parametrize("R,L,k", [(1, 1_000_000, 20), (559, 15000, 20),
                                   (53, 128, 20), (1000, 133, 20),
                                   (41, 5003, 32), (301, 15000, 20),
                                   (300, 77, 1), (7, 1044, 21), (0, 100, 20)])
def test_read_blocks_cover_every_window_once(R, L, k):
    """The kernel's grid, tiles times segments in order, covers each (row,
    window) of R rows of L codes once; a block holds at most a tile of rows
    and a segment of windows, and rows longer than a segment span that
    many blocks."""
    plan = K.read_plan(L, k)
    W = L - k + 1
    cover = np.zeros((R, W), dtype=np.int8)
    blocks = list(K.read_blocks(R, L, k))
    for r0, r1, w0, w1 in blocks:
        assert 0 < r1 - r0 <= plan["rows"] and 0 < w1 - w0 <= plan["seg"]
        cover[r0:r1, w0:w1] += 1
    assert (cover == 1).all()
    assert len(blocks) == -(-R // plan["rows"]) * plan["segs"]
    if R:
        spans = {(r0, r1) for r0, r1, _, _ in blocks}
        per_tile = len(blocks) // len(spans)
        assert per_tile == plan["segs"] and (per_tile > 1) == (W > K.READ_SEG)


@pytest.mark.parametrize("name", [n for n in trim_cases.COUNT_CASES
                                  if n != "long-read run"])
def test_read_split_plain_matches_read_counts_plain(name):
    """The mirror of the kernel's split and combine against
    read_counts_plain on the count cases the card runs (the long-read run,
    8.4 million windows, runs on the card only), at each of their
    thresholds, with their bigcount table."""
    primes, k, codes, lengths, fill, thresholds, big = \
        trim_cases.make_count_case(name)
    c, n = torch.from_numpy(codes), torch.from_numpy(lengths)
    flat = torch.from_numpy(fill)
    table = trim_cases.big_table(primes, k, flat, c, n, "cpu") if big \
        else None
    for C, X in thresholds:
        want = K.read_counts_plain(primes, k, C, X, flat, c, n, table)
        got = K.read_split_plain(primes, k, C, X, flat, c, n, table)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (C, X)


def _mutate(seq, i):
    return seq[:i] + {"A": "C", "C": "G", "G": "T", "T": "A"}[seq[i]] + \
        seq[i + 1:]


def _graphs(k, rng):
    """A JAX countgraph over a 6,000-base genome (three times) and a hot
    stretch past 255 into the bigcount map, and the port's from its
    state."""
    genome = "".join(rng.choice(list("ACGT"), 6000))
    jg = khmer_tpu.Countgraph(k, 100000, 3)
    jg.set_use_bigcount(True)
    for _ in range(3):
        jg.consume(genome)
    hot = genome[3000:3100]
    for _ in range(300):
        jg.consume(hot)
    pg = Countgraph.from_numpy_state(
        k, jg.hashsizes(), [np.asarray(t) for t in jg.get_raw_tables()],
        jg.n_unique_kmers(), 0, device="cpu", bigcounts=jg._bigcounts,
        use_bigcount=True)
    return jg, pg, genome, hot


@pytest.mark.parametrize("k", [1, 20, 32])
def test_read_split_plain_matches_jax_counts_for_records(k, monkeypatch):
    """read_split_plain, read_counts_plain and JAX's counts_for_records
    (host engine) with trim_pos_from_counts and
    median_at_least_from_counts agree on reads of 2,600 bases (three
    segments) whose one mutation makes a bad window only past the first
    segment, reads whose first base is mutated (window 0 bad alone),
    reads of 0, 1 and 2 windows, short random reads and the hot stretch,
    at cutoff and at_least of 0, equal, in either order and above 255."""
    monkeypatch.setenv("KHMER_TPU_ENGINE", "auto")
    rng = np.random.default_rng(40 + k)
    jg, pg, genome, hot = _graphs(k, rng)
    late = [_mutate(genome[s:s + 2600], 2000) for s in (0, 1500, 3400)]
    first = [_mutate(genome[s:s + 300], 0) for s in (100, 2000)]
    edges = [genome[:max(k - 1, 0)], genome[10:10 + k],
             genome[20:21 + k], ""]
    short = []
    for _ in range(40):
        m = int(rng.integers(k, 160))
        s = int(rng.integers(0, len(genome) - m))
        short.append(genome[s:s + m])
    seqs = late + first + edges + short + [hot, hot[:k + 1] + "A" * 40]
    counts = [c for _, c in jax_pipeline.counts_for_records(
        jg, [JaxRecord("q%d" % i, s) for i, s in enumerate(seqs)])]
    codes, lengths = (torch.from_numpy(a) for a in pack_reads(
        seqs, max(len(s) for s in seqs)))
    big = K.bigcount_table(pg._bigcounts, "cpu")
    flat = pg.tables.flat
    for C, X in ((2, 20), (20, 2), (0, 0), (0, 3), (3, 0), (4, 4),
                 (300, 300), (256, 260)):
        got = K.read_split_plain(pg._primes, k, C, X, flat, codes, lengths,
                                 big)
        want = K.read_counts_plain(pg._primes, k, C, X, flat, codes,
                                   lengths, big)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (C, X)
        for s, c, t, g in zip(seqs, counts, *got):
            assert t == jax_trimming.trim_pos_from_counts(c, k, C, len(s))
            assert g == int((c >= X).sum())
            if len(s) >= k:
                assert (g >= int(0.5 + (len(s) - k + 1) / 2.0)) == \
                    jax_trimming.median_at_least_from_counts(c, k, X, len(s))
        if k > 1 and C == 2:  # the cases the reads were built for
            trims = got[0].tolist()
            assert all(1023 + k <= t < 2000 + 1 for t in trims[:3])
            assert trims[3:5] == [0, 0]
            assert trims[5:9] == [0, 0, k + 1, 0]
