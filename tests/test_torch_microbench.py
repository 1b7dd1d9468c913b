"""The plain versions behind the ported microbenchmark kernels against the
JAX scripts they come from: histogram_add (kernel C) against the XLA twin
of scripts/profile_scatter2.py's pallas_hist, and proto_rmw (kernel D)
against scripts/pallas_proto.py's numpy oracle on the script's
correctness case. The TPU kernels themselves cannot run here; the
scripts are loaded by path and left as they are. Integer results: exact.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu_torch.core import blocked as B
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.scripts import pallas_proto, profile_scatter2

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    path = os.path.join(REPO, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location("jax_script_" + name,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_proto():
    return _jax_script("pallas_proto")


def test_profile_scatter2_script_loads_and_shapes_agree():
    ref = _jax_script("profile_scatter2")
    assert callable(ref.main)
    assert (profile_scatter2.M, profile_scatter2.PT) == (1 << 21, 1 << 17)


@pytest.mark.parametrize("m,nbins,out_of_range", [
    (profile_scatter2.M, profile_scatter2.PT, 0),
    (100_000, 65_537, 5_000),
    (4_096, 7, 1_000),
])
def test_histogram_add_plain_matches_xla_scatter_add(m, nbins,
                                                     out_of_range):
    """out[idx] += 1 as JAX's .at[].add does it: indices in [-nbins, 0)
    wrap to idx + nbins, as in numpy; indices >= nbins or < -nbins are
    dropped. Each kind is fed here, in thirds of `out_of_range`."""
    rng = np.random.default_rng(m)
    idx = rng.integers(0, nbins, m)
    bad = rng.choice(m, out_of_range, replace=False)
    high, low, wrap = bad[0::3], bad[1::3], bad[2::3]
    idx[high] = rng.integers(nbins, 2 * nbins + 5, len(high))
    idx[low] = -nbins - rng.integers(1, 1000, len(low))
    idx[wrap] = -rng.integers(1, nbins + 1, len(wrap))  # -nbins .. -1
    want = np.asarray(jnp.zeros(nbins, jnp.int32).at[
        jnp.asarray(idx.astype(np.int32))].add(1))
    if out_of_range:
        assert want.sum() == m - len(high) - len(low)
    start = rng.integers(0, 5, nbins)
    out = torch.from_numpy(start.copy())
    got = K.histogram_add(out, torch.from_numpy(idx))
    assert got is out and got.dtype == torch.int64
    assert np.array_equal(got.numpy(), start + want)
    assert np.array_equal(
        K.histogram_add_plain(torch.zeros(nbins, dtype=torch.int64),
                              torch.from_numpy(idx)).numpy(), want)


def test_pack_offs_matches_the_script(jax_proto):
    offs = np.random.default_rng(3).integers(0, 128, (500, 4)).astype(
        np.int32)
    assert np.array_equal(pallas_proto.pack_offs(offs),
                          jax_proto.pack_offs(offs))


def test_proto_rmw_plain_matches_the_oracle_on_the_scripts_case(jax_proto):
    bids, offs, table = pallas_proto.correctness_case(
        np.random.default_rng(0))
    assert table.shape == (64 * jax_proto.SLAB, jax_proto.LANES)
    assert len(bids) == 2 * jax_proto.TILE
    want_t, want_n = jax_proto.oracle(bids, offs, table)
    tab = torch.from_numpy(table.copy())
    nnew = B.proto_rmw(torch.from_numpy(bids),
                       torch.from_numpy(pallas_proto.pack_offs(offs)), tab)
    assert int(nnew) == want_n
    assert np.array_equal(tab.numpy(), want_t)
    # a second pass over the same events on the updated table
    want_t2, want_n2 = jax_proto.oracle(bids, offs, want_t)
    nnew = B.proto_rmw_plain(torch.from_numpy(bids),
                             torch.from_numpy(pallas_proto.pack_offs(offs)),
                             tab)
    assert int(nnew) == want_n2
    assert np.array_equal(tab.numpy(), want_t2)


def test_proto_rmw_plain_saturates_and_drops_bad_blocks(jax_proto):
    rng = np.random.default_rng(11)
    nb = 5
    bids, offs = pallas_proto.timing_events(rng, nb, 4000)
    bids[::7] = -1
    table = np.full((nb, B.LANES), 250, np.uint8)
    tab = torch.from_numpy(table.copy())
    bad = torch.from_numpy(bids.copy())
    bad[::11] = nb + 3  # past the table: invalid, like a negative id
    keep = bad.numpy() < nb
    want_t, want_n = jax_proto.oracle(
        np.where(keep, bids, -1),
        np.stack([(offs >> (8 * j)) & 127 for j in range(4)], 1), table)
    nnew = B.proto_rmw_plain(bad, torch.from_numpy(offs), tab)
    assert int(nnew) == want_n == 0
    assert np.array_equal(tab.numpy(), want_t)
    assert int(tab.max()) == 255


def test_proto_rmw_lanes_are_a_set(jax_proto):
    """A repeated offset is incremented once, as the Pallas kernel ORs
    its one-hots; the numpy oracle would increment it twice."""
    bids = np.asarray([0, 0], np.int32)
    offs = np.asarray([[5, 5, 40, 40], [5, 6, 7, 8]], np.int32)
    tab = torch.zeros((2, B.LANES), dtype=torch.uint8)
    nnew = B.proto_rmw_plain(torch.from_numpy(bids),
                             torch.from_numpy(pallas_proto.pack_offs(offs)),
                             tab)
    assert int(nnew) == 2
    assert tab[0, 5] == 2 and tab[0, 40] == 1 and tab[0, 6] == 1
    oracle_t, _ = jax_proto.oracle(bids, offs, np.zeros((2, B.LANES),
                                                        np.uint8))
    assert oracle_t[0, 5] == 3 and oracle_t[0, 40] == 2


def test_proto_rmw_cuda_refuses_cpu_tensors():
    """No fallback inside the kernel's wrapper: on CPU tensors it raises,
    and the dispatcher takes the plain version instead."""
    bids = torch.zeros(4, dtype=torch.int32)
    offs = torch.zeros(4, dtype=torch.int32)
    tab = torch.zeros((2, B.LANES), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        B.proto_rmw_cuda(bids, offs, tab)
    assert B.proto_rmw_cuda.launches == 0
    assert int(B.proto_rmw(bids, offs, tab)) == 1
    assert int(tab[0, 0]) == 4 and int(tab.sum()) == 4


def test_proto_rmw_plain_matches_the_oracle_on_the_crowded_case(jax_proto):
    """The crowded-bucket case that chip_smoke and the card's tests give
    kernel D (one lane per quarter, all ids valid), through the plain
    version and the script's oracle, two passes."""
    cases = {c[0]: c for c in pallas_proto.adversarial_cases(
        np.random.default_rng(20261019))}
    assert list(cases) == list(pallas_proto.ADVERSARIAL)
    _, bids, offs, table, passes = cases["crowded-bucket"]
    lanes = np.stack([(offs >> (8 * j)) & 127 for j in range(4)], 1)
    want_t = table
    tab = torch.from_numpy(table.copy())
    for _ in range(passes):
        want_t, want_n = jax_proto.oracle(bids, lanes, want_t)
        nnew = B.proto_rmw_plain(torch.from_numpy(bids),
                                 torch.from_numpy(offs), tab)
        assert int(nnew) == want_n
        assert np.array_equal(tab.numpy(), want_t)


def test_gather_floors_count_distinct_counters_and_sectors():
    """byte_gather_bench's floors: 12 B a hash plus each distinct counter,
    and the distinct 32-byte sectors of the flat buffer, over all tables."""
    from khmer_tpu_torch.scripts import byte_gather_bench

    primes = (13, 11, 7)
    h = np.asarray([0, 1, 13, 2**64 - 1, 2**63, 5, 5], dtype=np.uint64)
    idx = np.concatenate([h % np.uint64(p) + np.uint64(off) for p, off in
                          zip(primes, K.byte_offsets(primes))])
    nbytes, sectors = byte_gather_bench.gather_floors(
        primes, torch.from_numpy(h.view(np.int64)))
    assert nbytes == 12 * len(h) + len(np.unique(idx))
    assert sectors == len(np.unique(idx >> np.uint64(5)))
