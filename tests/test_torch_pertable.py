"""Kernel M's edge cases (scripts/pertable_cases.py) and the shape
builders and variants of scripts/pertable_bench.py, on the CPU. The
kernel itself runs only on the card (tests/test_torch_gpu_kernels.py)."""

import glob
import os
import re

import numpy as np
import pytest
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops import cuda
from khmer_tpu_torch.scripts import pertable_bench as PB
from khmer_tpu_torch.scripts import pertable_cases as PC

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

SOURCE = os.path.join(cuda.CSRC, "byte_gather.cu")


def _source():
    with open(SOURCE) as f:
        return f.read()


def test_constants_match_the_source():
    """The cases' block is kernel M's."""
    assert re.search(r"constexpr int kPerTableBlock = (\d+);",
                     _source()).group(1) == str(PC.BLOCK)


@pytest.mark.parametrize("side", list(PB.VARIANTS))
def test_variant_edits_apply_once(side):
    """Each of a pertable_bench side's edits finds its text in the source
    once; the side differs from the design where it has edits, and keeps
    one kernel M and one launch of it."""
    src = _source()
    text = PB.variant_source(src, side)
    assert (text != src) == bool(PB.VARIANTS[side])
    assert text.count("\npertable_kernel(") == 1
    assert text.count("pertable_kernel<<<") == 1


def test_a_variant_edit_that_misses_raises(monkeypatch):
    monkeypatch.setitem(PB.VARIANTS, "two", (("no such line", "x"),))
    with pytest.raises(RuntimeError, match="0 times"):
        PB.variant_source(_source(), "two")


def test_cases_hold_the_edges():
    """The cases hold n one below, at and one above a block's hashes (and
    around the 2,048 of a block of 8 hashes a thread), hash views at odd
    offsets and n over two chunks of 2^21 hashes; the small ones build on
    the CPU with the view where it is named."""
    tile = PC.BLOCK
    sizes = {case[3] for case in PC.PERTABLE_CASES.values()}
    assert {tile - 1, tile, tile + 1, 2047, 2049} <= sizes
    assert max(sizes) > 2 * (1 << 21)
    odd = [name for name, case in PC.PERTABLE_CASES.items() if case[4] % 2]
    assert odd
    for name in odd + ["block+1"]:
        primes, flat, hashes = PC.case_inputs(name, torch.device("cpu"))
        ntables, _, _, n, offset = PC.PERTABLE_CASES[name]
        assert hashes.shape == (n,) and hashes.is_contiguous()
        assert hashes.storage_offset() == offset
        assert len(primes) == ntables
        assert K.byte_pertable_plain(primes, flat, hashes).shape == (
            ntables, n)


def test_synth_hashes_are_distinct_and_seeded():
    h = PB.synth_hashes(200_000)
    assert h.dtype == np.uint64 and len(np.unique(h)) == 200_000
    assert (PB.synth_hashes(200_000) == h).all()
    assert (PB.synth_hashes(1000) == h[:1000]).all()
    assert not (PB.synth_hashes(1000, seed=19) == h[:1000]).any()
    # spread over the whole range, not near the seed's counter
    assert (h >> np.uint64(63)).sum() > 90_000


def test_shape_tables_are_as_named():
    """(b): four primes near 2e8 (800 MB); (d): near 1e9 (4 GB)."""
    for shape, x in (("b", 2e8), ("d", 1e9)):
        primes = PB.shape_primes(shape)
        assert primes == tuple(K.get_n_primes_near_x(4, x))
        assert all(0.99 * x < p <= x for p in primes)
        assert abs(K.byte_flat_size(primes) - 4 * x) < 0.01 * x
    assert PB.NHASH == 8_775_042


def test_random_tables_and_counts():
    """Seeded tables of the layout's size; torch.take at flat_indices is
    byte_pertable_plain; the sector floor counts distinct sectors."""
    dev = torch.device("cpu")
    primes = tuple(K.get_n_primes_near_x(3, 5000))
    flat = PB.random_tables(primes, dev)
    assert flat.shape == (K.byte_flat_size(primes),)
    assert torch.equal(flat, PB.random_tables(primes, dev))
    assert not torch.equal(flat, PB.random_tables(primes, dev, seed=19))
    hashes = torch.from_numpy(PB.synth_hashes(3000).view(np.int64))
    idx = PB.flat_indices(primes, hashes)
    assert torch.equal(torch.take(flat, idx),
                       K.byte_pertable_plain(primes, flat, hashes))
    c = PB.shape_counts(primes, flat, hashes, idx)
    assert c["sectors"] == len(np.unique(idx.numpy() >> 5))
    assert c["bound_ms"] == pytest.approx(11 * 3000 / 3.35e12 * 1e3)
    assert c["floor_ms"] == pytest.approx(
        c["sectors"] * 32 / 3.35e12 * 1e3)


def test_largest_call_keeps_the_largest_and_restores():
    """The capture keeps the largest call's inputs (its hashes copied)
    and puts byte_pertable and glob back."""
    primes = (101, 103)
    flat = torch.arange(K.byte_flat_size(primes), dtype=torch.uint8)
    calls = [torch.arange(n, dtype=torch.int64) for n in (5, 9, 3)]

    def step(h):
        return lambda args: K.pertable_counts(
            "byte", primes, K.ByteTables(flat, primes), h)

    fn, real = K.byte_pertable, glob.glob
    got = PB.largest_call([(step(h), []) for h in calls], os.getcwd())
    assert K.byte_pertable is fn and glob.glob is real
    assert got[0] == primes and got[1] is flat
    assert torch.equal(got[2], calls[1])
    calls[1].fill_(0)
    assert got[2][-1] == 8
