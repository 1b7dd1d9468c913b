"""The update kernels' scratch planning (khmer_tpu_torch/core/
sketch_kernels.py update_plan, bucket_of, update_scratch), which is plain
Python and runs here: the scratch and the bucket count follow the chunk
and the number of counters per event, never the table size, and the
buckets the kernels compute cover the flat counter range exactly once, in
contiguous ranges. The kernels themselves run only on the card
(tests/test_torch_gpu_kernels.py)."""

import numpy as np
import pytest
import torch

from khmer_tpu_torch import BlockedCountgraph, Countgraph
from khmer_tpu_torch.core import blocked as B
from khmer_tpu_torch.core import sketch_kernels as K

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("n,ntables", [(1, 1), (4096, 3), (1 << 20, 4),
                                       (1 << 20, 32), (200_320, 4)])
def test_plan_follows_the_chunk_not_the_table(n, ntables):
    nbuckets, parts, total = K.update_plan(n, ntables)
    lanes = n * ntables
    assert nbuckets == min(max(-(-lanes // K.BUCKET_TARGET), 1),
                           K.MAX_BUCKETS)
    assert list(parts) == list(K._PLAN_PARTS)
    # 4 B per lane-event, 8 B per bucket, 8 B per event
    want = {"ids": 4 * lanes,
            "start": 4 * (nbuckets + 1), "cursor": 4 * nbuckets,
            "ev_word": 4 * n, "min_old": 4 * n}
    end = 0
    for name, (off, size) in parts.items():
        assert size == want[name]
        assert off % 8 == 0 and off >= end
        end = off + size
    assert end <= total < end + 8 * len(parts)
    # the whole scratch is O(chunk x T): 4 B per lane-event plus small
    # change, whatever the table (nothing in the plan names a table)
    assert total <= 4 * lanes + 8 * n + 8 * nbuckets + 64
    # a larger chunk never needs fewer buckets or bytes
    nb2, _, total2 = K.update_plan(2 * n, ntables)
    assert nb2 >= nbuckets and total2 >= total


def test_plan_refuses_chunks_past_32_bit_positions():
    K.update_plan(K.MAX_LANE_EVENTS // 4 - 1, 4)
    with pytest.raises(ValueError, match="chunk too large"):
        K.update_plan(K.MAX_LANE_EVENTS // 4, 4)


@pytest.mark.parametrize("m", [1, 8192, 1 << 20, K.MAX_LANE_EVENTS // 4 - 1])
def test_decoded_event_plan_is_the_updates(m):
    """Kernel D (csrc/proto_rmw.cu) runs the update core on m decoded
    events of four lanes: its scratch is update_plan(m, 4), sized by the
    events alone; 2^20 events on 2^19 blocks take 25,231,368 B where the
    first design's int32 winner image took 4 B per counter, 268,435,456 B."""
    nbuckets, parts, total = K.update_plan(m, B.SUB)
    assert parts["ids"][1] == 4 * B.SUB * m
    assert total <= 4 * B.SUB * m + 8 * m + 8 * nbuckets + 64
    if m == 1 << 20:
        assert total == 25_231_368
        assert total < 4 * (1 << 19) * B.LANES == 268_435_456


def test_decoded_event_plan_refuses_past_the_limit():
    """The events' limit is the update's, m * 4 < 2^31, no longer the
    winner sentinel IDX_FILL; proto_rmw_cuda checks it before it looks
    for scratch or the card's library."""
    with pytest.raises(ValueError, match="chunk too large"):
        K.update_plan(K.MAX_LANE_EVENTS // B.SUB, B.SUB)

    class Events:  # only metadata is read before the check
        def __init__(self, dev):
            self.device = dev
            self.dtype = torch.int32
            self.shape = torch.Size([K.MAX_LANE_EVENTS // B.SUB])

        def dim(self):
            return 1

        def is_contiguous(self):
            return True

    class Table:
        device = torch.device("cuda", 0)
        dtype = torch.uint8
        shape = (7, B.LANES)

        def dim(self):
            return 2

        def is_contiguous(self):
            return True

    ev = Events(Table.device)
    with pytest.raises(ValueError, match="chunk too large"):
        B.proto_rmw_cuda(ev, ev, Table())
    assert B.proto_rmw_cuda.launches == 0


def _first_index(size, nbuckets, b):
    """Least index whose bucket is >= b (binary search; size if none)."""
    lo, hi = 0, size
    while lo < hi:
        mid = (lo + hi) // 2
        if K.bucket_of(mid, size, nbuckets) >= b:
            hi = mid
        else:
            lo = mid + 1
    return lo


@pytest.mark.parametrize("size,nbuckets", [
    (1, 1), (8, 1), (896, 4096), (1000, 7), (4 * 1009, 64), (40_000, 40),
])
def test_buckets_tile_small_ranges_exactly_once(size, nbuckets):
    got = np.asarray([K.bucket_of(i, size, nbuckets) for i in range(size)])
    assert got[0] == 0 and got.max() < nbuckets
    assert (np.diff(got) >= 0).all()  # monotone: contiguous ranges
    # each bucket holds about size / nbuckets counters
    sizes = np.bincount(got, minlength=nbuckets)
    assert sizes.sum() == size
    assert sizes.max() <= -(-size // nbuckets) + 1


@pytest.mark.parametrize("size", [
    199_999_712,                       # config 1, exact layout
    1_562_471 * 128,                   # config 1, blocked layout
    4 * 999_999_937,                   # -x 1e9 -N 4
    4 * 4_999_999_937,                 # -x 5e9 -N 4: 20 GB of counters
])
def test_buckets_tile_large_ranges_exactly_once(size):
    nbuckets, _, _ = K.update_plan(1 << 20, 4)
    firsts = [_first_index(size, nbuckets, b) for b in range(nbuckets + 1)]
    assert firsts[0] == 0 and firsts[-1] == size
    widths = np.diff(firsts)
    assert (widths >= 0).all() and widths.sum() == size
    # balanced; q = (2^64 - 1) // size is floored, so the last bucket may
    # come out a few counters short (about size^2 / 2^64)
    assert widths[:-1].max() - widths[:-1].min() <= 1
    assert widths[:-1].max() - size * size // 2**64 - 2 <= widths[-1]
    assert widths[-1] <= widths[:-1].max()
    # the ranges meet: the last index of each bucket precedes the next
    for b in (0, 1, nbuckets // 2, nbuckets - 1):
        assert K.bucket_of(firsts[b], size, nbuckets) == b
        assert K.bucket_of(firsts[b + 1] - 1, size, nbuckets) == b


def test_update_scratch_is_reused_when_large_enough():
    cpu = torch.device("cpu")
    small = K.update_scratch(None, 1000, 4, cpu)
    assert small.dtype == torch.uint8
    assert small.numel() == K.update_plan(1000, 4)[2]
    assert K.update_scratch(small, 10, 4, cpu) is small
    big = K.update_scratch(small, 100_000, 4, cpu)
    assert big is not small and big.numel() == K.update_plan(100_000, 4)[2]


@pytest.mark.parametrize("make", [
    lambda: Countgraph(20, 1e5, 4, device="cpu"),
    lambda: BlockedCountgraph(20, 1e5, 4, device="cpu"),
], ids=["Countgraph", "BlockedCountgraph"])
def test_sketches_on_the_cpu_keep_no_update_scratch(make):
    """The plain versions need no scratch; a CPU sketch keeps none and its
    tables are its only table-sized state."""
    g = make()
    g.count("ACGTACGTACGTACGTACGT")
    assert g.get("ACGTACGTACGTACGTACGT") == 1
    assert g._scratch is None
    assert not hasattr(g, "_winner")


@pytest.mark.parametrize("size", [1, 999, 1000, 1001, 12_345])
def test_byte_occupied_counts_in_slices(size, monkeypatch):
    """byte_occupied counts a table a slice at a time (its temporaries
    follow the slice, not the table) and gives the whole table's count
    across slice edges."""
    monkeypatch.setattr(K, "OCCUPIED_SLICE", 1000)
    rng = np.random.default_rng(size)
    table = torch.from_numpy(rng.integers(0, 3, size, dtype=np.uint8))
    assert int(K.byte_occupied(table)) == int((table != 0).sum())
