"""The plain blocked update and gather of khmer_tpu_torch against the JAX
package's blocked_local_update / blocked_update_core / gather_counts, on
adversarial seeded inputs. Integer state: equality is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu.core import blocked as JB
from khmer_tpu_torch.core import blocked as TB
from khmer_tpu_torch.core import sketch_kernels as TK

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

M = 8192


def _full(rng, n):
    return rng.integers(0, 2**64, n, dtype=np.uint64)


CASES = ["hashes>=2^63", "duplicates", "saturate-7-blocks",
         "saturate-101-blocks", "zero-padded-tail", "chunk-sequence"]


def _case(name):
    """(nblocks, [(hashes u64 [M], nvalid), ...]) of a named case."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "hashes>=2^63":
        return 101, [(_full(rng, M) | np.uint64(1 << 63), M)]
    if name == "duplicates":
        pool = _full(rng, 300)
        return 101, [(pool[rng.integers(0, 300, M)], M) for _ in range(2)]
    if name == "saturate-7-blocks":
        return 7, [(_full(rng, M), M) for _ in range(8)]
    if name == "saturate-101-blocks":
        pool = _full(rng, 50)
        return 101, [(pool[rng.integers(0, 50, M)], M) for _ in range(4)]
    if name == "zero-padded-tail":
        h = _full(rng, M)
        h[:7] = 0      # hash 0 is the all-A k-mer: real events
        h[3000:] = 0   # padding
        return 101, [(h, 3000)]
    if name == "chunk-sequence":
        out = []
        for i in range(4):
            h = _full(rng, M)
            h[M - 1000 * i:] = 0
            out.append((h, M - 1000 * i))
        return 100003, out
    raise KeyError(name)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64).copy())


@pytest.mark.parametrize("name", CASES)
def test_update_core_and_gather_match_jax(name):
    nb, chunks = _case(name)
    jax_update = JB.make_blocked_update(nb, with_event_new=True)
    jtabs = (jnp.zeros((nb, JB.LANES), jnp.uint8),)
    jnu = jnp.uint64(0)
    ttabs = (torch.zeros((nb, TB.LANES), dtype=torch.uint8),)
    tnu = torch.zeros(1, dtype=torch.int64)
    launches = (TB.blocked_update_cuda.launches,
                TB.blocked_gather_cuda.launches)
    for h, nvalid in chunks:
        valid = np.arange(M) < nvalid
        jtabs, out = jax_update(jtabs, jnu, jnp.asarray(h),
                                jnp.asarray(valid))
        jnu = out["n_unique"]
        flags = TB.blocked_update_core(nb, ttabs, tnu, _t(h), nvalid)
        assert (ttabs[0].numpy() == np.asarray(jtabs[0])).all()
        assert (flags.numpy() == np.asarray(out["event_new"])).all()
        assert int(tnu) == int(jnu)
    query = np.concatenate([h for h, _ in chunks]
                           + [_full(np.random.default_rng(1), 500)])
    want = np.asarray(JB.make_blocked_get(nb)(jtabs, jnp.asarray(query)))
    got = TB.gather_counts(nb, ttabs, _t(query).reshape(-1, 4))
    assert got.dtype == torch.int32 and got.shape == (len(query) // 4, 4)
    assert (got.reshape(-1).numpy() == want).all()
    assert int(TB._blocked_occupied(ttabs[0])) == \
        int(JB._blocked_occupied(jtabs[0]))
    # a CPU table takes the plain versions: no kernel launched
    assert (TB.blocked_update_cuda.launches,
            TB.blocked_gather_cuda.launches) == launches


@pytest.mark.parametrize("seed", [0, 1])
def test_local_update_with_ownership_mask_matches_jax(seed):
    """blocked_local_update with an arbitrary (non-prefix) `mine` mask and
    a pre-filled table, as a block-range shard sees it."""
    rng = np.random.default_rng(seed)
    nb = 101
    table = rng.integers(0, 3, (nb, JB.LANES), dtype=np.uint8)
    table[5] = 255
    h = _full(rng, 2048)
    h[100:300] = h[0]
    mine = rng.random(2048) < 0.6
    block = (h % np.uint64(nb)).astype(np.int32)
    idx = np.arange(2048, dtype=np.int32)
    jt, jf = JB.blocked_local_update(
        nb, jnp.asarray(table), jnp.asarray(h), jnp.asarray(block),
        jnp.asarray(idx), jnp.asarray(mine))
    tt, tf = TB.blocked_local_update(
        nb, torch.from_numpy(table.copy()), _t(h),
        torch.from_numpy(block).long(), torch.from_numpy(idx),
        torch.from_numpy(mine))
    assert (tt.numpy() == np.asarray(jt)).all()
    assert (tf.numpy() == np.asarray(jf)).all()


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback inside a kernel wrapper: it launches or raises."""
    table = torch.zeros((7, TB.LANES), dtype=torch.uint8)
    h = torch.zeros(4, dtype=torch.int64)
    nu = torch.zeros(1, dtype=torch.int64)
    scratch = torch.empty(TK.update_plan(4, TB.SUB)[2], dtype=torch.uint8)
    with pytest.raises(ValueError):
        TB.blocked_update_cuda(table, h, 4, nu, scratch)
    with pytest.raises(ValueError):
        TB.blocked_gather_cuda(table, h)
    assert TB.blocked_update_cuda.launches == 0
    assert TB.blocked_gather_cuda.launches == 0


def test_batch_size_cap():
    """Event indices must stay below IDX_FILL, the winner sentinel."""
    class Huge:  # only .shape is read before the check
        shape = (TB.IDX_FILL,)

    with pytest.raises(ValueError):
        TB.blocked_local_update(7, None, Huge(), None, None, None)
