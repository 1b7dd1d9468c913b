"""Kernel P's plan and records (khmer_tpu_torch/core/sketch_kernels.py
nibble_update_plan, nibble_tiles, nibble_buckets, nibble_update_scratch),
which are plain Python and run here: the scratch
and the bucket count follow the chunk and the number of tables, never the
tables' size; the word buckets cover the flat buffer's words exactly once,
each word (so all 8 of its nibbles) in one bucket, from tables of a few
bytes to 20 GB; a record's 32-bit offset fits at every size P takes. A
numpy mirror of P's records (events grouped by hash in runs of 32, each
group's lowest event with its occurrences saturated at 15, its counters
placed by word bucket) and of its commit (each nibble's occurrences and
lowest event over its bucket) is held to nibble_update_plain and to JAX's
make_update on the nibble kind, exactly. The kernel itself runs only on
the card (tests/test_torch_gpu_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from khmer_tpu.core import sketch_kernels as JK
from khmer_tpu_torch import SmallCountgraph
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.scripts import nibble_cases

# six xdist workers share the cores: one intra-op thread each
torch.set_num_threads(1)

WARP = 32  # events a group of equal hashes is found in (a warp)
GB = 10**9


def record_place(key, span):
    """(bucket, offset in it) of flat nibble `key`, as kernel P computes
    them: the bucket of its word key // 8, and the nibble's offset from the
    bucket's first word, 8 * (key // 8 % span) + key % 8."""
    word = int(key) >> 3
    return word // span, 8 * (word % span) + (int(key) & 7)


@pytest.mark.parametrize("n,ntables", [(1, 1), (1000, 4), (4096, 3),
                                       (1 << 20, 4), (1_130_496, 4),
                                       (1 << 20, 20), (30_001, 32)])
def test_plan_follows_the_chunk_not_the_tables(n, ntables):
    nbuckets, parts, total = K.nibble_update_plan(n, ntables)
    lanes = n * ntables
    assert nbuckets == min(max(-(-lanes // K.NIBBLE_BUCKET_TARGET),
                               K.NIBBLE_MIN_BUCKETS), K.NIBBLE_MAX_BUCKETS)
    assert list(parts) == list(K._NIBBLE_PARTS)
    # 8 B a record, its bucket's count and start, a tile's place in a
    # bucket, a flag byte an event in whole words
    tiles, per_tile = K.nibble_tiles(n, ntables)
    assert per_tile % 32 == 0 and per_tile * ntables <= K.NIBBLE_STAGE
    assert (tiles - 1) * per_tile < n <= tiles * per_tile
    want = {"recs": 8 * lanes, "counts": 4 * nbuckets,
            "start": 4 * (nbuckets + 1), "offsets": 4 * tiles * nbuckets,
            "flags": -(-n // 4) * 4}
    end = 0
    for name, (off, size) in parts.items():
        assert size == want[name]
        assert off % 8 == 0 and off >= end
        end = off + size
    assert end <= total < end + 8 * len(parts)
    # the tiles' places: at most 4 B a lane-event while a tile's records
    # outnumber the buckets (4 tables of 2^20 events: 683 tiles, 1,171
    # buckets)
    assert total <= 8 * lanes + n + 8 * nbuckets + 4 * tiles * nbuckets + 64
    if per_tile * ntables >= nbuckets:
        assert 4 * tiles * nbuckets <= 4 * lanes + 4 * nbuckets
    # a larger chunk never needs fewer buckets or bytes
    nb2, _, total2 = K.nibble_update_plan(2 * n, ntables)
    assert nb2 >= nbuckets and total2 >= total


def test_plan_names_no_table():
    """The plan takes the chunk and the table count alone, so tables of
    any size share it; the wrapper sizes its scratch by it."""
    import inspect

    assert list(inspect.signature(K.nibble_update_plan).parameters) == [
        "n", "ntables"]
    cpu = torch.device("cpu")
    buf = K.nibble_update_scratch(None, 1000, 4, cpu)
    assert buf.numel() == K.nibble_update_plan(1000, 4)[2]
    assert K.nibble_update_scratch(buf, 10, 4, cpu) is buf
    big = K.nibble_update_scratch(buf, 100_000, 4, cpu)
    assert big is not buf
    assert big.numel() == K.nibble_update_plan(100_000, 4)[2]


def test_plan_refuses_chunks_past_the_record():
    K.nibble_update_plan(K.NIBBLE_MAX_EVENTS - 1, 1)
    with pytest.raises(ValueError, match="chunk too large"):
        K.nibble_update_plan(K.NIBBLE_MAX_EVENTS, 1)
    K.nibble_update_plan(K.MAX_LANE_EVENTS // 16 - 1, 16)
    with pytest.raises(ValueError, match="chunk too large"):
        K.nibble_update_plan(K.MAX_LANE_EVENTS // 16, 16)


def test_small_countgraph_keeps_no_scratch_on_the_cpu():
    g = SmallCountgraph(20, 1000, 4, device="cpu")
    g.consume("ACGTACGTACGTACGTACGTAC")
    assert g._scratch is None


# flat sizes in bytes: nibble_cases' tiny odd primes, small tables, the
# port's phases (100 MB, 4 GB), 20 GB, and the largest a record takes at
# P's fewest buckets
SIZES = [K.nibble_flat_size(p) for p in (
    nibble_cases.case_primes("tiny-odd-primes"), (7, 11), (101,),
    tuple(K.get_n_primes_near_x(4, 1e5)))] + [
    4, 8, 100_004, 100 * 10**6, 4 * GB, 20 * GB,
    K.NIBBLE_MIN_BUCKETS * K.NIBBLE_MAX_SPAN_WORDS * 4]
CHUNKS = [(1, 4), (1000, 4), (1 << 20, 4), (1 << 20, 20)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("n,ntables", CHUNKS)
def test_buckets_tile_the_words_once(size, n, ntables):
    """Buckets [b * span, (b + 1) * span) cover the buffer's words once,
    in order; a word's 8 nibbles share its bucket; every offset fits 32
    bits; the last bucket in use holds a word."""
    nbuckets = K.nibble_update_plan(n, ntables)[0]
    span, used = K.nibble_buckets(size, nbuckets)
    words = size // 4
    assert 1 <= used <= nbuckets
    assert used * span >= words > (used - 1) * span
    assert 8 * span <= 2**32
    if words <= 4096:
        sample = np.arange(words)
    else:
        edges = np.arange(used, dtype=np.int64) * span
        sample = np.unique(np.concatenate([
            edges, edges - 1, edges + 1, [words - 1, words // 2]]))
        sample = sample[(sample >= 0) & (sample < words)]
    for w in sample.tolist():
        places = [record_place(8 * w + q, span) for q in range(8)]
        assert {b for b, _ in places} == {w // span}
        assert [off for _, off in places] == [
            8 * (w % span) + q for q in range(8)]
        assert all(0 <= off < 2**32 for _, off in places)
        assert places[0][0] < used


def test_offsets_fit_every_size_up_to_the_limit():
    """At P's fewest buckets (a call of one event) 8 * span fits 32 bits
    for every buffer up to 128 GiB (80 GB is the card's memory); past it
    nibble_buckets raises."""
    nb = K.nibble_update_plan(1, 1)[0]
    assert nb == K.NIBBLE_MIN_BUCKETS
    for size in (4, 4 * GB, 20 * GB, 80 * GB,
                 nb * K.NIBBLE_MAX_SPAN_WORDS * 4):
        span, _ = K.nibble_buckets(size, nb)
        assert 8 * span <= 2**32
    with pytest.raises(ValueError, match="too large"):
        K.nibble_buckets(nb * K.NIBBLE_MAX_SPAN_WORDS * 4 + 4, nb)


# -- a numpy mirror of P's records and commit ---------------------------------


def mirror_records(primes, size, h, nvalid):
    """P's records of hashes h[:nvalid] (count and scatter, csrc/
    nibble_update.cu): (bucket, offset, occurrences, event) arrays, one a
    (group of equal hashes in a run of 32 events, table)."""
    n = int(nvalid)
    span = K.nibble_buckets(size, K.nibble_update_plan(n, len(primes))[0])[0]
    i = np.arange(n, dtype=np.uint64)
    pairs = np.stack([i // np.uint64(WARP), h[:n]], 1)
    _, lead, occ = np.unique(pairs, axis=0, return_index=True,
                             return_counts=True)
    lead = lead.astype(np.uint64)
    occ = np.minimum(occ, K.NIBBLE_MAX)
    out = []
    for off_t, p in zip(K.nibble_offsets(primes), primes):
        key = h[lead] % np.uint64(p) + np.uint64(2 * off_t)
        word = key >> np.uint64(3)
        out.append((word // np.uint64(span),
                    np.uint64(8) * (word % np.uint64(span))
                    + (key & np.uint64(7)), occ, lead))
    return [np.concatenate(c) for c in zip(*out)], span


def mirror_update(primes, flat, n_unique, h, nvalid):
    """P in numpy on u8 `flat` (in place): each nibble's occurrences
    (saturated) and lowest event over its records, a word's nibbles
    written together, the lowest event of a nibble that was 0 flagged.
    Returns (flags, records)."""
    (bucket, off, occ, ev), span = mirror_records(primes, flat.size, h,
                                                  nvalid)
    assert off.max(initial=0) < 2**32 and ev.max(initial=0) < 2**28
    key = bucket * np.uint64(8 * span) + off
    order = np.lexsort((ev, key))
    key, occ, ev = key[order], occ[order], ev[order]
    first = np.r_[True, key[1:] != key[:-1]]
    starts = np.flatnonzero(first)
    ukey = key[starts]
    uocc = np.minimum(np.add.reduceat(occ, starts), K.NIBBLE_MAX)
    uev = ev[starts]  # sorted by event within a nibble
    byte = (ukey >> np.uint64(1)).astype(np.int64)
    high = (ukey & np.uint64(1)) == 0
    old = np.where(high, flat[byte] >> 4, flat[byte] & 0xF).astype(np.int64)
    post = np.minimum(old + uocc, K.NIBBLE_MAX)
    # a byte's two nibbles may both change: the high ones, then the low
    for sel, keep, shift in ((high, 0x0F, 4), (~high, 0xF0, 0)):
        b = byte[sel]
        flat[b] = ((flat[b] & keep) | (post[sel] << shift)).astype(np.uint8)
    flags = np.zeros(int(nvalid), bool)
    flags[uev[old == 0].astype(np.int64)] = True
    n_unique += int(flags.sum())
    return flags, (bucket, off)


MIRROR_CASES = ["one-hash-x2^20", "duplicates-past-15", "all-8-nibbles-a-word",
                "words-at-bucket-edges", "tiny-odd-primes", "zero-padded-tail",
                "twenty-tables", "both-nibbles-one-chunk"]


@pytest.mark.parametrize("name", MIRROR_CASES)
def test_mirror_matches_plain_and_jax(name):
    """nibble_cases' chunks (the largest cut to 2^16 events) through the
    mirror, nibble_update_plain and JAX's make_update from the same tables:
    tables, n_unique and new flags equal after every chunk; every record
    lies in a bucket in use, inside its span."""
    ntables, x, chunks, m, _ = nibble_cases.NIBBLE_CASES[name]
    m = min(m, 1 << 16)
    primes = nibble_cases.case_primes(name)
    rng = np.random.default_rng(len(name) * 7919)
    upd = JK.make_update("nibble", primes, with_event_new=True)
    jt = JK.init_tables("nibble", primes)
    jn = jnp.uint64(0)
    tables = K.init_tables("nibble", primes, "cpu")
    mirror = tables.flat.numpy().copy()
    nu_m = np.zeros(1, np.int64)
    nu_p = torch.zeros(1, dtype=torch.int64)
    nbuckets = None
    for c in range(chunks):
        h, nvalid = nibble_cases._chunk_hashes(name, primes, c, m, rng)
        valid = np.arange(h.shape[0]) < nvalid
        jt, out = upd(jt, jn, jnp.asarray(h), jnp.asarray(valid))
        jn = out["n_unique"]
        want = K.nibble_update_plain(
            primes, tables.flat, nu_p,
            torch.from_numpy(h.view(np.int64).copy()), nvalid,
            with_event_new=True).numpy()
        got, (bucket, off) = mirror_update(primes, mirror, nu_m, h, nvalid)
        nbuckets = K.nibble_update_plan(nvalid, ntables)[0]
        span, used = K.nibble_buckets(mirror.size, nbuckets)
        assert bucket.max() < used and off.max() < 8 * span
        assert (got == want).all()
        assert (want == np.asarray(out["event_new"])[:nvalid]).all()
        assert int(nu_m[0]) == int(nu_p) == int(jn)
        assert (mirror == tables.flat.numpy()).all()
        joined = np.concatenate([np.asarray(t) for t in jt])
        assert (tables.flat.numpy()[:joined.size] == joined).all()
    assert int(nu_m[0]) > 0 and nbuckets >= K.NIBBLE_MIN_BUCKETS


def test_groups_stand_for_equal_hashes_in_runs_of_32():
    """One hash 2^16 times is one record a table a run of 32 events, its
    lowest event and 15 occurrences; equal hashes in two runs are two
    records."""
    primes = (101, 103)
    size = K.nibble_flat_size(primes)
    h = np.full(1 << 16, np.uint64(12345))
    (bucket, off, occ, ev), _ = mirror_records(primes, size, h, h.size)
    assert bucket.size == 2 * (h.size // WARP)
    assert (occ == 15).all()
    assert set(ev.tolist()) == set(range(0, h.size, WARP))
    h2 = np.array([7, 7, 9] + [0] * 29 + [7], np.uint64)
    (_, _, occ2, ev2), _ = mirror_records(primes, size, h2, h2.size)
    assert sorted(zip(ev2.tolist(), occ2.tolist()))[::2] == [
        (0, 2), (2, 1), (3, 15), (32, 1)]
