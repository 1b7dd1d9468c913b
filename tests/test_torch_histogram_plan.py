"""Kernel C's launch plan and kernel 2's reduction, which are plain Python
and run here (khmer_tpu_torch/core/sketch_kernels.py histogram_plan and
histogram_add_cuda's split into launches; ops/u64.py umod_reciprocal at
the blocked layout's block counts), histogram_add_plain against JAX's
.at[].add on abundance-shaped batches, and one abundance-dist step, whose
indices kernel C takes, against JAX's. The kernels themselves run only on
the card (tests/test_torch_gpu_kernels.py). Integer results: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu_torch.core import blocked as B
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops import u64
from khmer_tpu_torch.scripts.byte_gather_bench import reduction_edges

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

H100_SMS = 132


@pytest.mark.parametrize("n", [1, 2048, 2049, 5_000, 1_785_856, 1 << 21,
                               2**31 - 1])
def test_plan_fills_the_card_but_no_more_than_the_work(n):
    blocks = K.histogram_plan(n, H100_SMS)
    per_block = K.HIST_THREADS * K.HIST_PER_THREAD
    # one wave: two blocks of 512 threads an SM
    assert 1 <= blocks <= H100_SMS * K.HIST_BLOCKS_PER_SM == 264
    # every block has indices to count, and the blocks take them all in
    # one trip each unless the card is full
    assert (blocks - 1) * per_block < n
    assert blocks * per_block >= n or blocks == 264


def test_plan_at_the_main_paths_shapes():
    # abundance-dist's batch and profile_scatter2's indices fill the card
    assert K.histogram_plan(1_785_856, H100_SMS) == 264
    assert K.histogram_plan(1 << 21, H100_SMS) == 264
    # a small input takes few blocks: 2,048 indices a block
    assert K.histogram_plan(5_000, H100_SMS) == 3
    # and one SM takes two
    assert K.histogram_plan(5_000, 1) == 2
    assert K.histogram_plan(10**6, 1) == 2


def test_plan_never_takes_fewer_blocks_for_more_indices():
    for sms in (1, 16, H100_SMS):
        got = [K.histogram_plan(n, sms)
               for n in (1, 10**3, 10**4, 10**5, 10**6, 10**7)]
        assert got == sorted(got)


class _FakeCuda:
    """Tensor metadata as the wrapper reads it before each launch."""

    def __init__(self, n, ptr):
        self.device = torch.device("cuda", 0)
        self.dtype = torch.int64
        self.shape = torch.Size([n])
        self._ptr = ptr

    def dim(self):
        return 1

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self._ptr


def test_wrapper_splits_what_one_launch_cannot_take(monkeypatch):
    """No index count JAX accepts is refused: past HIST_LAUNCH_LIMIT the
    wrapper issues consecutive launches, each planned for its own part."""
    calls = []

    class Lib:
        @staticmethod
        def khmer_histogram_add(idx, n, out, nbins, *rest):
            calls.append((idx, n, out, nbins) + rest)
            return 0

    monkeypatch.setattr(K.cuda, "library", lambda: Lib)
    monkeypatch.setattr(K, "_stream", lambda dev: 7)
    monkeypatch.setattr(K, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(K.histogram_add_cuda, "launches", 0)
    n = 2**31 + 5
    out = _FakeCuda(65_537, 1 << 40)
    K.histogram_add_cuda(out, _FakeCuda(n, 1 << 20))
    limit = K.HIST_LAUNCH_LIMIT
    assert limit == 2**31 - 1
    assert [c[:4] for c in calls] == [
        (1 << 20, limit, 1 << 40, 65_537),
        ((1 << 20) + 8 * limit, n - limit, 1 << 40, 65_537)]
    assert calls[0][4] == K.histogram_plan(limit, H100_SMS)
    assert calls[1][4] == K.histogram_plan(n - limit, H100_SMS)
    assert calls[1][5:] == (0, 7)
    assert K.histogram_add_cuda.launches == 2
    # a lowered limit splits a small input the same way
    calls.clear()
    monkeypatch.setattr(K, "HIST_LAUNCH_LIMIT", 1000)
    K.histogram_add_cuda(out, _FakeCuda(2500, 0))
    assert [(c[0], c[1]) for c in calls] == [(0, 1000), (8000, 1000),
                                             (16000, 500)]


@pytest.mark.parametrize("nbins", [3, 256, 257, 65_537])
def test_histogram_add_plain_matches_jax_on_an_abundance_batch(nbins):
    """abundance-dist's batch shape at 65,537 bins: three quarters of the
    indices crowded on one bin, the top one, counts 1..255 below it, and
    wrapped negatives, into a nonzero histogram; and the same on as few
    bins as sit around kernel C's private range."""
    rng = np.random.default_rng(nbins)
    m = 200_000
    idx = np.full(m, nbins - 1, dtype=np.int64)
    live = rng.choice(m, m // 4, replace=False)
    idx[live] = np.minimum(rng.geometric(0.6, len(live)), min(255, nbins))
    wrap = rng.choice(live, 2_000, replace=False)
    idx[wrap] = -rng.integers(1, nbins + 1, len(wrap))  # -nbins .. -1
    idx[live[-1000:]] = rng.integers(nbins, 2 * nbins + 1, 1000)  # dropped
    want = np.asarray(jnp.zeros(nbins, jnp.int32).at[
        jnp.asarray(idx.astype(np.int32))].add(1))
    start = rng.integers(0, 1000, nbins)
    got = K.histogram_add(torch.from_numpy(start.copy()),
                          torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), start + want)
    assert want[nbins - 1] >= 3 * m // 4 - len(wrap)


def test_abundance_step_matches_jax_step():
    """One abundance-dist step (make_abund_dist through abund_batch) on a
    seeded batch, with duplicates, invalid slots and saturated counts,
    against JAX's: the same tracking tables, histogram bins
    0..MAX_BIGCOUNT and saturated count. The port drops the slots it does
    not count (index ABUND_BINS); JAX adds them to a bin past the
    histogram, which its caller drops."""
    from khmer_tpu.core import sketch_kernels as JK

    rng = np.random.default_rng(11)
    primes, track_primes = (1009, 1013, 1019, 1021), (10007, 10009)
    tables = [np.where(rng.random(p) < 0.7, 255,
                       rng.integers(1, 4, p)).astype(np.uint8)
              for p in primes]
    pool = rng.integers(0, 2**64, 3000, dtype=np.uint64)
    hashes = pool[rng.integers(0, 3000, 8192)]
    valid = rng.random(8192) < 0.9

    jstep = JK.make_abund_dist("bit", track_primes, "byte", primes)
    jtrack, jdist, jsat, _ = jstep(
        JK.init_tables("bit", track_primes),
        jnp.zeros(K.MAX_BIGCOUNT + 2, dtype=jnp.uint64),
        tuple(jnp.asarray(t) for t in tables), jnp.asarray(hashes),
        jnp.asarray(valid))

    main = K.init_tables("byte", primes, "cpu")
    for view, t in zip(main, tables):
        view.copy_(torch.from_numpy(t))
    track = K.init_tables("bit", track_primes, "cpu")
    dist = torch.zeros(K.ABUND_BINS, dtype=torch.int64)
    step = K.make_abund_dist("bit", track_primes, "byte", primes)
    n_sat, _ = step(track, dist, main,
                    torch.from_numpy(hashes.view(np.int64)),
                    torch.from_numpy(valid))
    jdist = np.asarray(jdist).astype(np.int64)
    assert np.array_equal(dist.numpy(), jdist[:K.ABUND_BINS])
    assert dist[1:4].sum() > 0 and jdist[K.ABUND_BINS] > 0
    assert int(n_sat) == int(jsat) > 0
    for t, jt in zip(track, jtrack):
        assert np.array_equal(t.numpy(), np.asarray(jt))


BLOCK_COUNTS = [1, 2, 1_562_471, 16_777_213, 2**31 - 1]


@pytest.mark.parametrize("nblocks", BLOCK_COUNTS)
def test_umod_reciprocal_at_the_blocked_block_counts(nblocks):
    """Kernels 1 and 2 reduce h % nblocks by the reciprocal
    (csrc/u64_common.cuh reduce); mirrored step for step, it equals
    numpy's uint64 % at 0, 2^63 - 1, 2^63, 2^64 - 1 and around multiples
    of nblocks, low and at the top of the u64 range."""
    rng = np.random.default_rng(nblocks)
    k = rng.integers(1, 2**64 // nblocks, 2000, dtype=np.uint64)
    mults = np.concatenate([k * np.uint64(nblocks) + np.uint64(d)
                            for d in (0, 1)]
                           + [k[k > 1] * np.uint64(nblocks) - np.uint64(1)])
    a = np.concatenate([reduction_edges((nblocks,), 4000), mults])
    x = torch.from_numpy(a.view(np.int64).copy())
    got = u64.umod_reciprocal(x, nblocks).numpy()
    assert (got == (a % np.uint64(nblocks)).astype(np.int64)).all()
    assert (got == u64.umod(x, nblocks).numpy()).all()


def test_block_counts_cover_the_layouts_range():
    # config 1 (BlockedCountgraph's rule for -x 5e7 -N 4), and the
    # largest prime block count the layout allows
    assert K.get_n_primes_near_x(1, int(5e7) * 4 // B.LANES + 1)[0] == \
        BLOCK_COUNTS[2]
    assert K.get_n_primes_near_x(1, B.MAX_BLOCKS + 1)[0] == BLOCK_COUNTS[3]
