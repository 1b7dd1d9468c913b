"""Batch update and query building blocks for the sketches.

Counterpart of khmer_tpu/core/sketch_kernels.py, the subset the counting
slices need: the exact byte layout (update with its bigcount report,
gather, the per-table gather (kernel M), occupancy), the nibble layout
(update, gather and per-table gather: kernels P, Q and R), the bit (Bloom)
table update with per-event new flags (kernel J: the Nodegraph and the
abundance histogram's tracking table), the HLL add (kernel K), the
8-neighbour probe of the bit tables and their gather (kernel L), the
count gathers, the histogram step, and diginorm's median test and
keep/consume scan (the XLA functions of khmer_tpu/core/diginorm_scan.py).
A whole batch is committed at once, exactly equivalent to the sequential
order of the batch:

- per-event "is new": the reference counts an add as new iff some
  table's bin was zero at that moment (storage.hh:571-624); within a
  batch only the first event to hit a fresh bin gets credit, found by
  sorting each table's bins and crediting per-bin winners ordered by
  batch position.

Hashes are int64 tensors holding u64 bit patterns (ops/u64.py). Where
the JAX version returned new tables (donated buffers), these functions
update the tables in place.
"""

import ctypes
import functools

import numpy as np
import torch

from khmer_tpu_torch.ops import cuda
from khmer_tpu_torch.ops.hashing import rolling_hash_windows
from khmer_tpu_torch.ops.u64 import _SIGN, srl, to_signed, ult, umin, umod

MAX_KCOUNT = 255      # reference: include/oxli/oxli.hh:81
MAX_BIGCOUNT = 65535  # reference: include/oxli/oxli.hh:82

_I32_MAX = 2**31 - 1
_I64_MAX = 2**63 - 1

# winner sentinel of the plain versions of the blocked updates
# (blocked.blocked_local_update, blocked.proto_rmw_plain); events per batch
# must stay below it. No kernel uses it.
IDX_FILL = 1 << 30

_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int64)


def _starts(keys, active):
    """Segment starts of a sorted key array: active rows whose key or
    activity differs from the row before."""
    n = keys.shape[0]
    first = torch.arange(n, device=keys.device) == 0
    return active & (first | (keys != torch.roll(keys, 1))
                     | ~torch.roll(active, 1))


def _segments(starts, active):
    """Segment id per row (cumulative starts); inactive rows get id M,
    one past the last real segment, so scatters into M+1 slots drop
    them."""
    seg = torch.cumsum(starts.to(torch.int64), 0) - 1
    return torch.where(active, seg, starts.shape[0])


def _dedup_batch(hashes, valid):
    """Sort + dedup a batch of hashes preserving batch-order information.

    Returns dict with, per "unique slot" (M slots; inactive padded):
      uh       [M] i64   unique hash (u64 bits; 0 for inactive slots)
      ufirst   [M] i32   smallest batch index among occurrences
      uvalid   [M] bool  slot active
    Slots follow the unsigned order of the hashes, as in JAX.
    """
    M = hashes.shape[0]
    dev = hashes.device
    idx = torch.arange(M, dtype=torch.int32, device=dev)
    inv = (~valid).to(torch.uint8)
    # lexicographic (inv, unsigned hash) by two stable sorts
    order = torch.argsort(hashes ^ _SIGN, stable=True)
    order = order[torch.argsort(inv[order], stable=True)]
    h_s = hashes[order]
    v_s = inv[order] == 0
    first = _starts(h_s, v_s)
    seg = _segments(first, v_s)
    ufirst = torch.full((M + 1,), _I32_MAX, dtype=torch.int32,
                        device=dev).scatter_reduce_(
        0, seg, idx[order], "amin")[:M]
    # every row of a segment holds the same hash
    uh = torch.zeros(M + 1, dtype=torch.int64, device=dev).scatter_(
        0, seg, h_s)[:M]
    uvalid = torch.arange(M, device=dev) < first.sum()
    return {"uh": uh, "ufirst": ufirst, "uvalid": uvalid}


def _group_by_bin(bins, ufirst, active):
    """Sort unique-slot bins; group; mark per-bin winners (min ufirst).

    Returns (bins_s, perm, v_s, bwin): bin-sorted bins, permutation into
    unique-slot order, active flags, winner flags.
    """
    bins_m = torch.where(active, bins, _I64_MAX)
    first_m = torch.where(active, ufirst, _I32_MAX)
    # lexicographic (bin, first) by two stable sorts
    perm = torch.argsort(first_m, stable=True)
    perm = perm[torch.argsort(bins_m[perm], stable=True)]
    bins_s = bins_m[perm]
    v_s = active[perm]
    return bins_s, perm, v_s, _starts(bins_s, v_s)


def _bit_table_update(table, prime, d):
    """BitStorage Bloom filter (reference storage.hh:95-229), in place.

    Returns credit_u [M] in unique-slot order: whether the hash is the
    first batch event to set a fresh bin.
    """
    M = d["uh"].shape[0]
    dev = table.device
    bins = umod(d["uh"], prime)
    bins_s, perm, v_s, bwin = _group_by_bin(bins, d["ufirst"], d["uvalid"])
    byte_idx = torch.where(v_s, bins_s // 8, 0)
    bitval = torch.bitwise_left_shift(
        torch.ones_like(byte_idx, dtype=torch.int32),
        (bins_s % 8).to(torch.int32))
    old_byte = table[byte_idx].to(torch.int32)
    old_bit = (old_byte & bitval) != 0
    # bins sorted implies bytes sorted; group bins by byte for the scatter
    byfirst = _starts(byte_idx, v_s)
    byseg = _segments(byfirst, v_s)
    # OR of the winner bits in this byte == sum (bits are distinct powers)
    or_mask = torch.zeros(M + 1, dtype=torch.int32, device=dev).index_add_(
        0, byseg, torch.where(bwin, bitval, 0))[:M]
    new_byte = or_mask[torch.where(v_s, byseg, M - 1)] | old_byte
    table[byte_idx[byfirst]] = new_byte[byfirst].to(torch.uint8)
    credit_u = torch.zeros(M, dtype=torch.bool, device=dev)
    credit_u[perm] = bwin & ~old_bit
    return credit_u


def _apply_update(kind, primes, tables, d):
    """Update all tables in place; returns any_credit_u [M]: whether the
    unique slot was first to a fresh bin in any table. Bit tables only: it
    serves bit_update_plain, and the byte and nibble tables update through
    byte_update and nibble_update, which take the events themselves."""
    if kind != "bit":
        raise ValueError("%s tables update through their own entry point"
                         % kind)
    any_credit = torch.zeros(d["uh"].shape[0], dtype=torch.bool,
                             device=d["uh"].device)
    for t, p in enumerate(primes):
        any_credit = any_credit | _bit_table_update(tables[t], p, d)
    return any_credit


# --------------------------------------------------------------------------
# the bit layout (BitStorage, reference storage.hh:95-229): kernel J
# --------------------------------------------------------------------------


def bit_table_bytes(prime):
    """Bytes of one bit table of `prime` bits, as khmer stores it."""
    return int(prime) // 8 + 1


def bit_offsets(primes):
    """Start (in bytes) of each bit table in the joined buffer."""
    return [int(o) for o in np.cumsum(
        [0] + [bit_table_bytes(p) for p in primes[:-1]])]


def bit_flat_size(primes):
    """Length of the joined bit buffer: the tables' bytes, padded to
    whole 32-bit words (kernel J sets bits with 32-bit atomics; nothing
    reads or writes the padding)."""
    return (sum(bit_table_bytes(p) for p in primes) + 3) // 4 * 4


class BitTables(tuple):
    """The T bit tables of a Nodegraph: views of exactly p_t // 8 + 1
    bytes (what save and load write) into one flat u8 buffer, ``flat``.
    Bit b of table t is bit b % 8 of its byte b // 8, so flat bit
    8 * offset_t + b: kernel J names every bit of the sketch by one
    64-bit index into the flat buffer."""

    def __new__(cls, flat, primes):
        views = [flat[o:o + bit_table_bytes(p)]
                 for o, p in zip(bit_offsets(primes), primes)]
        obj = super().__new__(cls, views)
        obj.flat = flat
        return obj


def _event_mask(hashes, nvalid, valid):
    live = torch.arange(hashes.shape[0], device=hashes.device) < int(nvalid)
    return live if valid is None else live & valid


def bit_update_plain(primes, tables, n_unique, hashes, nvalid, valid=None):
    """Bloom-filter test-and-set of the events i < nvalid (and valid[i],
    where a mask is given) over the T bit tables, in stream order, in
    place (plain PyTorch, any device): JAX's bit path, _dedup_batch +
    _apply_update, with the per-event flags of its _update_dispatch
    (pipeline.py:242-254). An event is new iff, in some table, it is the
    lowest-index event of the batch to touch a bit that was 0 before it:
    sequential BitStorage::add. Returns the new flags, bool [M]; n_unique
    (int64 [1]) grows by their count."""
    M = hashes.shape[0]
    d = _dedup_batch(hashes, _event_mask(hashes, nvalid, valid))
    new_u = d["uvalid"] & _apply_update("bit", primes, tables, d)
    n_unique += new_u.sum()
    flags = torch.zeros(M + 1, dtype=torch.bool, device=hashes.device)
    flags[torch.where(new_u, d["ufirst"].to(torch.int64), M)] = True
    return flags[:M]


BIT_SAMPLE = 1024  # events kernel J's sample probes (csrc kSample)
# the probe runs where at most this percent of the sample's lanes are open
# (csrc kProbeMaxOpen)
BIT_PROBE_MAX_OPEN = 57


def _zero_lanes(primes, flat, h):
    """int64 [n]: bit t set iff hash h[i]'s bit in table t of the joined
    bit buffer `flat` is 0."""
    out = torch.zeros(h.shape[0], dtype=torch.int64, device=h.device)
    for t, (p, off) in enumerate(zip(primes, bit_offsets(primes))):
        b = umod(h, p) + 8 * off
        bit = (flat[b // 8].to(torch.int64) >> (b % 8)) & 1
        out |= (bit == 0).to(torch.int64) << t
    return out


def bit_open_lanes(mask):
    """The open lanes of bit_probe_plain's lane masks."""
    return int(_popcount(mask).sum())


def _popcount(mask):
    return sum((mask >> t) & 1 for t in range(MAX_TABLES))


def bit_sample_plain(primes, flat, hashes, nvalid, valid=None):
    """Kernel J's sample (plain PyTorch, any device): whether the probe
    runs. It looks at events j * nvalid // BIT_SAMPLE, j < BIT_SAMPLE,
    and runs iff at most BIT_PROBE_MAX_OPEN percent of their lanes are
    open (their bit is 0)."""
    n = int(nvalid)
    if n == 0:
        return True
    i = torch.arange(BIT_SAMPLE, device=hashes.device) * n // BIT_SAMPLE
    live = _event_mask(hashes, n, valid)[i]
    opened = _popcount(_zero_lanes(primes, flat, hashes[i][live])).sum()
    return (100 * int(opened)
            <= BIT_PROBE_MAX_OPEN * len(primes) * int(live.sum()))


def bit_probe_plain(primes, flat, hashes, nvalid, valid=None):
    """Kernel J's sample and probe (plain PyTorch, any device): the lane
    mask of each event i < nvalid, int64 [nvalid], 0 for an event that
    takes no part (valid[i] false, where a mask is given). Where the
    sample lets the probe run (bit_sample_plain), bit t of an event's mask
    is set iff its bit in table t is 0; else every bit of the T is (every
    lane goes to the commit)."""
    n = int(nvalid)
    live = _event_mask(hashes, n, valid)[:n]
    if bit_sample_plain(primes, flat, hashes, n, valid):
        lanes = _zero_lanes(primes, flat, hashes[:n])
    else:
        lanes = torch.full((n,), (1 << len(primes)) - 1, dtype=torch.int64,
                           device=hashes.device)
    return torch.where(live, lanes, 0)


def bit_commit_plain(primes, flat, n_unique, hashes, mask):
    """Kernel J's commit after its probe (plain PyTorch, any device): over
    the lanes of `mask` (bit_probe_plain) alone, each distinct bit they
    touch that is 0 is set and credits its lowest event, in place; events
    with no such lane are not new. Returns the new flags, bool [M];
    n_unique grows by their count. With the probe's mask from the same
    tables it equals bit_update_plain: every lane on a bit that was 0
    before the chunk is in the mask."""
    M = hashes.shape[0]
    n = mask.shape[0]
    dev = hashes.device
    idx = torch.arange(n, device=dev)
    fresh = torch.zeros(n, dtype=torch.bool, device=dev)
    for t, (p, off) in enumerate(zip(primes, bit_offsets(primes))):
        lane = ((mask >> t) & 1) == 1
        b = umod(hashes[:n][lane], p) + 8 * off
        was0 = ((flat[b // 8].to(torch.int64) >> (b % 8)) & 1) == 0
        b, ev = b[was0], idx[lane][was0]
        ub, inv = torch.unique(b, return_inverse=True)
        first = torch.full(ub.shape, n, dtype=torch.int64,
                           device=dev).scatter_reduce_(0, inv, ev, "amin")
        fresh[first] = True
        # the bits were 0, so their sum in a byte is their OR
        byte, binv = torch.unique(ub // 8, return_inverse=True)
        add = torch.zeros(byte.shape, dtype=torch.int64,
                          device=dev).index_add_(0, binv, 1 << (ub % 8))
        flat[byte] = (flat[byte].to(torch.int64) | add).to(torch.uint8)
    n_unique += fresh.sum()
    flags = torch.zeros(M, dtype=torch.bool, device=dev)
    flags[:n] = fresh
    return flags


def bit_update_cuda(primes, tables, n_unique, hashes, nvalid, valid=None,
                    scratch=None):
    """Kernel J (csrc/bit_update.cu): bit_update_plain on the card, for
    the BitTables `tables`: its sample and probe, then the bucketed commit
    of the lanes the probe leaves open (bit_probe_plain,
    bit_commit_plain).
    `scratch` is as for byte_update_cuda (update_plan(nvalid, T) bytes,
    sized by the events, never by the tables; the probe's lane masks take
    its min_old part, and stay there after the call). Returns the new
    flags, bool [M]. Counts its launches in ``bit_update_cuda.launches``."""
    flat = tables.flat
    dev = flat.device
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors, not %s" % dev)
    if not 1 <= len(primes) <= MAX_TABLES:
        raise ValueError("kernel J takes 1 to %d tables, not %d"
                         % (MAX_TABLES, len(primes)))
    if (flat.dtype != torch.uint8 or flat.dim() != 1
            or not flat.is_contiguous() or flat.data_ptr() % 4 != 0
            or flat.shape[0] != bit_flat_size(primes)):
        raise ValueError("tables.flat must be the contiguous uint8 buffer "
                         "of bit_flat_size(primes) = %d bytes"
                         % bit_flat_size(primes))
    if hashes.device != dev or hashes.dtype != torch.int64 \
            or hashes.dim() != 1 or not hashes.is_contiguous():
        raise ValueError("hashes must be a contiguous 1-D int64 tensor on %s"
                         % dev)
    M = hashes.shape[0]
    n = int(nvalid)
    if not 0 <= n <= M:
        raise ValueError("nvalid %d outside [0, %d]" % (n, M))
    if valid is not None and (valid.device != dev
                              or valid.dtype != torch.bool
                              or valid.shape != (M,)
                              or not valid.is_contiguous()):
        raise ValueError("valid must be a contiguous bool [%d] tensor on %s"
                         % (M, dev))
    if (n_unique.device != dev or n_unique.dtype != torch.int64
            or n_unique.numel() != 1):
        raise ValueError("n_unique must be an int64 [1] tensor on %s" % dev)
    flags = torch.empty(M, dtype=torch.bool, device=dev)
    # held until the launch: the allocator may not hand it out meanwhile
    scratch = update_scratch(scratch, n, len(primes), dev)
    nbuckets, ptr = _scratch_ptrs(scratch, n, len(primes))
    primes_arr, offsets_arr = _layout(primes, bits=True)
    err = cuda.library().khmer_bit_update(
        flat.data_ptr(), flat.shape[0], len(primes),
        ctypes.addressof(primes_arr), ctypes.addressof(offsets_arr),
        hashes.data_ptr(), _ptr(valid), M, n, nbuckets, *ptr,
        flags.data_ptr(), n_unique.data_ptr(), dev.index, _stream(dev))
    cuda.check(err, "bit_update")
    bit_update_cuda.launches += 1
    return flags


bit_update_cuda.launches = 0


def bit_update(primes, tables, n_unique, hashes, nvalid, valid=None,
               scratch=None):
    """Bloom-filter update of the events i < nvalid (and valid[i]), in
    place; returns their new flags: kernel J on CUDA tables, the plain
    version on CPU ones."""
    if tables.flat.is_cuda:
        return bit_update_cuda(primes, tables, n_unique, hashes, nvalid,
                               valid, scratch)
    if tables.flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % tables.flat.device)
    return bit_update_plain(primes, tables, n_unique, hashes, nvalid, valid)


# --------------------------------------------------------------------------
# the 8-neighbour probe of the bit tables and their gather (kernel L)
# --------------------------------------------------------------------------


def neighbor_kmers(f, r, k):
    """The 8 neighbours (nf, nr), int64 [N, 8] of u64 bit patterns, of the
    k-mers (f, r) [N]: 0-3 to the right with base j, 4-7 to the left with
    base j - 4 (JAX graphmixin.py make_neighbors_fn :41-52)."""
    mask = to_signed((1 << (2 * k)) - 1)
    shift = 2 * k - 2
    b = torch.arange(4, dtype=torch.int64, device=f.device)[None, :]
    comp = b ^ 1
    f, r = f[:, None], r[:, None]
    nf = torch.cat([((f << 2) | b) & mask, srl(f, 2) | (b << shift)], 1)
    nr = torch.cat([srl(r, 2) | (comp << shift), ((r << 2) | comp) & mask],
                   1)
    return nf, nr


def bit_present_plain(primes, flat, hashes):
    """Whether each hash (any shape) has its bit set in every one of the T
    bit tables of the joined buffer `flat` -> bool (plain PyTorch, any
    device)."""
    present = torch.ones(hashes.shape, dtype=torch.bool,
                         device=hashes.device)
    for p, off in zip(primes, bit_offsets(primes)):
        b = umod(hashes, p) + 8 * off
        present &= ((flat[b >> 3].to(torch.int64) >> (b & 7)) & 1) == 1
    return present


def _pack_bits(bits):
    """bool [N, 8] -> uint8 [N], bit j from column j."""
    shifts = torch.arange(8, dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64) << shifts).sum(1).to(torch.uint8)


def neighbors_plain(primes, flat, f, r, k):
    """Kernel L's probe (plain PyTorch, any device): uint8 [N], bit j set
    iff neighbour j (neighbor_kmers) of node (f[i], r[i]) is in the bit
    tables, its canonical value min(nf, nr) present in every table."""
    nf, nr = neighbor_kmers(f, r, k)
    return _pack_bits(bit_present_plain(primes, flat, umin(nf, nr)))


def bit_gather_plain(primes, flat, hashes):
    """Kernel L's gather (plain PyTorch, any device): 1 where a hash (any
    shape) is in the bit tables, else 0 -> int32."""
    return bit_present_plain(primes, flat, hashes).to(torch.int32)


def _check_bit_args(primes, flat, *hashes):
    dev = flat.device
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors, not %s" % dev)
    if not 1 <= len(primes) <= MAX_TABLES:
        raise ValueError("kernel L takes 1 to %d tables, not %d"
                         % (MAX_TABLES, len(primes)))
    if (flat.dtype != torch.uint8 or flat.dim() != 1
            or not flat.is_contiguous()
            or flat.shape[0] != bit_flat_size(primes)):
        raise ValueError("flat must be the contiguous uint8 buffer of "
                         "bit_flat_size(primes) = %d bytes"
                         % bit_flat_size(primes))
    for h in hashes:
        if h.device != dev or h.dtype != torch.int64 or h.dim() != 1 \
                or not h.is_contiguous():
            raise ValueError("k-mers must be contiguous 1-D int64 tensors "
                             "on %s" % dev)
    if len(hashes) == 2 and hashes[0].shape != hashes[1].shape:
        raise ValueError("f and r differ in length")


def neighbors_cuda(primes, flat, f, r, k):
    """Kernel L (csrc/neighbors.cu): neighbors_plain on the card, for the
    joined bit buffer `flat` -> uint8 [N]. Counts its launches in
    ``neighbors_cuda.launches``."""
    _check_bit_args(primes, flat, f, r)
    if not 1 <= int(k) <= 32:
        raise ValueError("k %d outside [1, 32]" % k)
    n = f.shape[0]
    dev = flat.device
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    primes_arr, offsets_arr = _layout(primes, bits=True)
    err = cuda.library().khmer_neighbors(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), f.data_ptr(), r.data_ptr(), n,
        int(k), out.data_ptr(), dev.index, _stream(dev))
    cuda.check(err, "neighbors")
    neighbors_cuda.launches += 1
    return out


neighbors_cuda.launches = 0


def neighbors(primes, flat, f, r, k):
    """Present-neighbour bytes of the nodes (f, r) (int64 [N] tensors on
    the tables' device): kernel L on a CUDA buffer, the plain version on
    a CPU one."""
    if flat.is_cuda:
        return neighbors_cuda(primes, flat, f, r, k)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return neighbors_plain(primes, flat, f, r, k)


def bit_gather_cuda(primes, flat, hashes):
    """Kernel L's gather mode (csrc/neighbors.cu) of a 1-D int64 hash
    tensor -> int32 [n]. Counts its launches in
    ``bit_gather_cuda.launches``."""
    _check_bit_args(primes, flat, hashes)
    n = hashes.shape[0]
    dev = flat.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    primes_arr, offsets_arr = _layout(primes, bits=True)
    err = cuda.library().khmer_bit_gather(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), hashes.data_ptr(), n, out.data_ptr(),
        dev.index, _stream(dev))
    cuda.check(err, "bit_gather")
    bit_gather_cuda.launches += 1
    return out


bit_gather_cuda.launches = 0


def bit_gather(primes, flat, hashes):
    """Presence (0/1, int32) of a hash tensor of any shape in the bit
    tables: kernel L's gather mode on a CUDA buffer, the plain version on
    a CPU one."""
    if flat.is_cuda:
        flat_h = hashes.reshape(-1).contiguous()
        return bit_gather_cuda(primes, flat, flat_h).reshape(hashes.shape)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return bit_gather_plain(primes, flat, hashes)


# --------------------------------------------------------------------------
# the 8-neighbour probe of the byte tables, with an abundance band (kernel N)
# --------------------------------------------------------------------------


def byte_neighbors_plain(primes, flat, f, r, k, band=None, big=None):
    """Kernel N's probe (plain PyTorch, any device): the presence byte
    uint8 [N] of the nodes (f[i], r[i]), bit j set iff the least counter m
    of neighbour j (neighbor_kmers) over the T byte tables joined in `flat`
    is at least 1 (JAX's make_neighbors_fn, byte kind). With a band (lo,
    hi), (presence, band byte): bit j of the band byte is set iff max(lo,
    1) <= m <= hi, a count of 255 read through `big` (bigcount_table) where
    the map has its hash."""
    nf, nr = neighbor_kmers(f, r, k)
    counts = byte_counts_plain(primes, flat, umin(nf, nr),
                               None if band is None else big)
    present = _pack_bits(counts >= 1)
    if band is None:
        return present
    lo, hi = band
    return present, _pack_bits((counts >= max(int(lo), 1))
                               & (counts <= int(hi)))


# Levels of fewer nodes than this go through kernel N's small-level mode
# (a lane a (neighbour, table) pair, one round trip), larger ones through
# its staged mode (eight lanes a node, table 0 first, fewer loads): where
# the two cross on the walks' levels of phases 12 (in L2) and 12b (4 GB,
# cold) replayed on an H100 (scripts/nbr_bench.py, PERF.md).
NBR_SMALL_NODES = 1024


def _check_nodes(f, r, k, dev):
    """Raise unless the nodes (f, r) of a probe are contiguous 1-D int64
    tensors of one length on `dev` and k lies in [1, 32]."""
    for h in (f, r):
        if h.device != dev or h.dtype != torch.int64 or h.dim() != 1 \
                or not h.is_contiguous():
            raise ValueError("k-mers must be contiguous 1-D int64 tensors "
                             "on %s" % dev)
    if f.shape != r.shape:
        raise ValueError("f and r differ in length")
    if not 1 <= int(k) <= 32:
        raise ValueError("k %d outside [1, 32]" % k)


def byte_neighbors_cuda(primes, flat, f, r, k, band=None, big=None,
                        small=None):
    """Kernel N (csrc/neighbors.cu): byte_neighbors_plain on the card, for
    the joined byte buffer `flat`, in its small-level mode where `small`
    (None: below NBR_SMALL_NODES nodes), else its staged mode. Counts its
    launches in ``byte_neighbors_cuda.launches`` (staged) and
    ``byte_neighbors_cuda.small_launches``."""
    _check_byte_layout(primes, flat)
    dev = flat.device
    _check_nodes(f, r, k, dev)
    n = f.shape[0]
    present = torch.empty(n, dtype=torch.uint8, device=dev)
    if band is None:
        lo, hi, big, in_band = 1, MAX_KCOUNT, None, None
    else:
        lo, hi = band
        big = _big_arg(big, dev)
        in_band = torch.empty(n, dtype=torch.uint8, device=dev)
    result = present if band is None else (present, in_band)
    if n == 0:
        return result
    keys, values = big or (None, None)
    primes_arr, offsets_arr = _layout(primes)
    if small is None:
        small = n < NBR_SMALL_NODES
    err = cuda.library().khmer_byte_neighbors(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), f.data_ptr(), r.data_ptr(), n,
        int(k), *_band_args(lo, hi), _ptr(keys), _ptr(values),
        0 if keys is None else keys.shape[0], present.data_ptr(),
        _ptr(in_band), int(bool(small)), dev.index, _stream(dev))
    cuda.check(err, "byte_neighbors")
    if small:
        byte_neighbors_cuda.small_launches += 1
    else:
        byte_neighbors_cuda.launches += 1
    return result


byte_neighbors_cuda.launches = 0
byte_neighbors_cuda.small_launches = 0


def _band_args(lo, hi):
    """A band [lo, hi] clamped as the C entry points take it."""
    return (max(_cutoff_arg(lo, MAX_BIGCOUNT), 0),
            min(_cutoff_arg(hi, MAX_BIGCOUNT), MAX_BIGCOUNT))


def byte_neighbors(primes, flat, f, r, k, band=None, big=None):
    """Presence bytes of the nodes (f, r) (int64 [N] tensors on the
    tables' device) in the byte tables, with a band (presence, band
    bytes): kernel N on a CUDA buffer, the plain version on a CPU one (see
    byte_neighbors_plain)."""
    if flat.is_cuda:
        return byte_neighbors_cuda(primes, flat, f, r, k, band, big)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return byte_neighbors_plain(primes, flat, f, r, k, band, big)


def nibble_neighbors_plain(primes, flat, f, r, k, band=None):
    """Kernel N's nibble mode (plain PyTorch, any device): the presence
    byte uint8 [N] of the nodes (f[i], r[i]), bit j set iff the least
    4-bit counter m of neighbour j (neighbor_kmers) over the T nibble
    tables joined in `flat` is at least 1 (JAX's make_neighbors_fn,
    nibble kind). With a band (lo, hi), (presence, band byte): bit j of
    the band byte is set iff max(lo, 1) <= m <= hi (no bigcount; m
    saturates at 15)."""
    nf, nr = neighbor_kmers(f, r, k)
    counts = nibble_gather_plain(primes, flat, umin(nf, nr))
    present = _pack_bits(counts >= 1)
    if band is None:
        return present
    lo, hi = band
    return present, _pack_bits((counts >= max(int(lo), 1))
                               & (counts <= int(hi)))


def nibble_neighbors_cuda(primes, flat, f, r, k, band=None, small=None):
    """Kernel N's nibble mode (csrc/neighbors.cu khmer_nibble_neighbors):
    nibble_neighbors_plain on the card, for the joined nibble buffer
    `flat`, in its small-level mode where `small` (None: below
    NBR_SMALL_NODES nodes), else its staged mode. Counts its launches in
    ``nibble_neighbors_cuda.launches`` (staged) and
    ``nibble_neighbors_cuda.small_launches``."""
    _check_nibble_layout(primes, flat)
    dev = flat.device
    _check_nodes(f, r, k, dev)
    n = f.shape[0]
    present = torch.empty(n, dtype=torch.uint8, device=dev)
    if band is None:
        lo, hi, in_band = 1, MAX_KCOUNT, None
    else:
        lo, hi = band
        in_band = torch.empty(n, dtype=torch.uint8, device=dev)
    result = present if band is None else (present, in_band)
    if n == 0:
        return result
    primes_arr, offsets_arr = _layout(primes, nibbles=True)
    if small is None:
        small = n < NBR_SMALL_NODES
    err = cuda.library().khmer_nibble_neighbors(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), f.data_ptr(), r.data_ptr(), n,
        int(k), *_band_args(lo, hi), present.data_ptr(), _ptr(in_band),
        int(bool(small)), dev.index, _stream(dev))
    cuda.check(err, "nibble_neighbors")
    if small:
        nibble_neighbors_cuda.small_launches += 1
    else:
        nibble_neighbors_cuda.launches += 1
    return result


nibble_neighbors_cuda.launches = 0
nibble_neighbors_cuda.small_launches = 0


def nibble_neighbors(primes, flat, f, r, k, band=None):
    """Presence bytes of the nodes (f, r) (int64 [N] tensors on the
    tables' device) in the nibble tables, with a band (presence, band
    bytes): kernel N's nibble mode on a CUDA buffer, the plain version on
    a CPU one (see nibble_neighbors_plain)."""
    if flat.is_cuda:
        return nibble_neighbors_cuda(primes, flat, f, r, k, band)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return nibble_neighbors_plain(primes, flat, f, r, k, band)


class LevelProbe:
    """A walk's probe of its levels on the card (csrc/neighbors.cu
    khmer_probe_ctx_new), by the tables' `kind`: kernel L on the joined
    bit buffer `flat` ("bit"), kernel N on the joined byte buffer ("byte")
    or N's nibble mode on the joined nibble buffer ("nibble"), k-mers of
    size k, with a band (lo, hi) and N's bigcount table `big`
    (bigcount_table; byte tables only) where given; N's small-level mode
    below
    NBR_SMALL_NODES nodes. Hand (probe, block, ctx) to ops/host.py
    _LevelWalk.run: each level then costs one copy up from the context's
    pinned block, the kernel, one copy back and a stream sync, all in C.
    count() adds the launches since its last call to the wrappers' counts
    (neighbors_cuda.launches; byte_neighbors_cuda.launches and
    .small_launches; nibble_neighbors_cuda's likewise); stats() gives the
    context's clocks. close() frees the context."""

    STATS = ("launches", "small_launches", "upload_s", "launch_s",
             "copy_back_s", "sync_s")

    # khmer_probe_ctx_new's layout kinds
    KINDS = {"byte": 0, "bit": 1, "nibble": 2}

    def __init__(self, primes, flat, k, kind, band=None, big=None):
        if kind not in self.KINDS:
            raise ValueError("no probe of %r tables" % (kind,))
        self.kind = kind
        {"bit": _check_bit_args, "byte": _check_byte_layout,
         "nibble": _check_nibble_layout}[kind](primes, flat)
        if not 1 <= int(k) <= 32:
            raise ValueError("k %d outside [1, 32]" % k)
        dev = flat.device
        big = None if self.kind != "byte" or band is None \
            else _big_arg(big, dev)
        keys, values = big or (None, None)
        lo, hi = _band_args(*band) if band is not None else (1, MAX_KCOUNT)
        primes_arr, offsets_arr = _layout(primes, bits=kind == "bit",
                                          nibbles=kind == "nibble")
        self._lib = cuda.library()
        self.ctx = self._lib.khmer_probe_ctx_new(
            flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
            ctypes.addressof(offsets_arr), self.KINDS[self.kind], int(k),
            int(band is not None), lo, hi, _ptr(keys), _ptr(values),
            0 if keys is None else keys.shape[0], NBR_SMALL_NODES,
            dev.index, _stream(dev))
        if not self.ctx:
            raise ValueError("khmer_probe_ctx_new refused its arguments")
        # the tensors the context reads
        self._held = (flat, big)
        self.probe = ctypes.cast(
            {"bit": self._lib.khmer_bit_probe_level,
             "byte": self._lib.khmer_byte_probe_level,
             "nibble": self._lib.khmer_nibble_probe_level}[self.kind],
            ctypes.c_void_p).value
        self.block = ctypes.cast(self._lib.khmer_probe_block,
                                 ctypes.c_void_p).value
        self._counted = (0, 0)

    def stats(self):
        """{launches (L, or N's staged mode), small_launches (N's), and
        host seconds issuing the uploads, the launches and the copies back,
        and waiting in the syncs}."""
        out = (ctypes.c_double * len(self.STATS))()
        self._lib.khmer_probe_ctx_stats(self.ctx, out)
        return dict(zip(self.STATS, out))

    def count(self):
        """Add the launches since the last count to the wrappers'."""
        s = self.stats()
        now = (int(s["launches"]), int(s["small_launches"]))
        staged, small = (a - b for a, b in zip(now, self._counted))
        self._counted = now
        if self.kind == "bit":
            neighbors_cuda.launches += staged
            return
        wrapper = (nibble_neighbors_cuda if self.kind == "nibble"
                   else byte_neighbors_cuda)
        wrapper.launches += staged
        wrapper.small_launches += small

    def close(self):
        if getattr(self, "ctx", None):
            self._lib.khmer_probe_ctx_free(self.ctx)
            self.ctx = None

    __del__ = close


# --------------------------------------------------------------------------
# HyperLogLog: murmur + register max of a flat chunk (kernel K)
# --------------------------------------------------------------------------

# A flat chunk is reads' 2-bit codes back to back (int8/uint8 [n]), the
# ascending start offsets of the reads that begin in it (int64; entries
# >= fill are ignored) and its fill. Window i is valid iff i + k <= fill
# and no start lies in (i, i + k - 1]: it lies inside one read.


def flat_valid_windows(starts, fill, k):
    """The number of valid windows of a flat chunk (numpy starts)."""
    s = np.asarray(starts, dtype=np.int64)
    edges = np.unique(np.concatenate([[0], s[s < fill], [fill]]))
    return int(np.maximum(np.diff(edges) - k + 1, 0).sum())


def _flat_window_mask(starts, fill, k, device):
    W = fill - k + 1
    rid = torch.zeros(fill + 1, dtype=torch.int64, device=device)
    s = starts[starts < fill]
    rid.index_add_(0, s, torch.ones_like(s))
    rid = torch.cumsum(rid[:fill], 0)
    return rid[:W] == rid[k - 1:fill]


def _bit_length(x):
    """Bits of non-negative int64 values (0 for 0), by halving."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        big = x >= (1 << s)
        n = n + torch.where(big, s, 0)
        x = torch.where(big, x >> s, x)
    return n + (x > 0).to(torch.int64)


def hll_index_rho(h, p):
    """HLL register index (the low p bits) and value rho = clz64(h >> p)
    - p + 1 (clz64(0) = 64) of u64 hashes (int64 bit patterns): JAX
    hll.py _make_add_batch's arithmetic."""
    rest = srl(h, p)
    rho = 64 - _bit_length(rest) - p + 1
    return h & ((1 << p) - 1), rho


def _hll_check(registers):
    nc = registers.shape[0]
    if (registers.dtype != torch.uint8 or registers.dim() != 1
            or nc < 16 or nc & (nc - 1) or not registers.is_contiguous()):
        raise ValueError("registers must be a contiguous uint8 tensor of "
                         "2^p >= 16 entries")
    return nc.bit_length() - 1


def hll_add_plain(registers, codes, starts, fill, k):
    """Max each valid window's rho into the HLL registers, in place (plain
    PyTorch, any device): the canonical murmur hash of every valid
    k-window of the flat chunk (ops/hashing.murmur_hash_windows), its
    register index and rho, then a scatter-max (JAX hll.py _make_add_batch
    over _hll_flat_hash)."""
    p = _hll_check(registers)
    fill = int(fill)
    if fill < k:
        return registers
    from khmer_tpu_torch.ops.hashing import murmur_hash_windows

    h = murmur_hash_windows(codes[:fill], k)[0]
    valid = _flat_window_mask(starts, fill, k, codes.device)
    index, rho = hll_index_rho(h[valid], p)
    registers.scatter_reduce_(0, index, rho.to(torch.uint8), "amax")
    return registers


HLL_THREADS = 512        # threads a block (csrc kThreads)
HLL_RUN = 28             # windows a thread slides over (kRun)
HLL_TILE = HLL_THREADS * HLL_RUN  # windows a block stages at a time (kTile)
HLL_SMEM_P = 14          # p up to which a block keeps its own registers
HLL_BLOCKS_PER_SM = 2    # blocks an SM (the kernel's launch bounds)


def hll_add_cuda(registers, codes, starts, fill, k):
    """Kernel K (csrc/hll_add.cu): hll_add_plain on the card, murmur and
    register max fused in one launch, HLL_BLOCKS_PER_SM blocks an SM at
    most. Counts its launches in ``hll_add_cuda.launches``."""
    p = _hll_check(registers)
    dev = registers.device
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors, not %s" % dev)
    if codes.device != dev or codes.dtype != torch.uint8 \
            or codes.dim() != 1 or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous uint8 tensor on %s"
                         % dev)
    if starts.device != dev or starts.dtype != torch.int64 \
            or starts.dim() != 1 or not starts.is_contiguous():
        raise ValueError("starts must be a contiguous int64 tensor on %s"
                         % dev)
    fill = int(fill)
    if not 0 <= fill <= codes.shape[0]:
        raise ValueError("fill %d outside [0, %d]" % (fill, codes.shape[0]))
    if not 1 <= k <= HLL_TILE:
        raise ValueError("kernel K takes 1 <= k <= %d" % HLL_TILE)
    nwin = fill - k + 1
    if nwin <= 0:
        return registers
    blocks = max(1, min(_sm_count(dev.index) * HLL_BLOCKS_PER_SM,
                        -(-nwin // HLL_TILE)))
    err = cuda.library().khmer_hll_add(
        codes.data_ptr(), fill, starts.data_ptr(), starts.shape[0], k, p,
        registers.data_ptr(), blocks, dev.index, _stream(dev))
    cuda.check(err, "hll_add")
    hll_add_cuda.launches += 1
    return registers


hll_add_cuda.launches = 0


def hll_add(registers, codes, starts, fill, k):
    """Max the flat chunk's valid windows into the HLL registers, in
    place: kernel K on CUDA tensors, the plain version on CPU ones."""
    if registers.is_cuda:
        return hll_add_cuda(registers, codes, starts, fill, k)
    if registers.device.type != "cpu":
        raise ValueError("unsupported device %s" % registers.device)
    return hll_add_plain(registers, codes, starts, fill, k)


# --------------------------------------------------------------------------
# the exact byte layout (ByteStorage, reference storage.hh:571-624)
# --------------------------------------------------------------------------

MAX_TABLES = 32  # csrc/byte_common.cuh kMaxTables


def byte_offsets(primes):
    """Start of each table in the joined byte buffer."""
    return [int(o) for o in np.cumsum([0] + [int(p) for p in primes[:-1]])]


def byte_flat_size(primes):
    """Length of the joined buffer: sum(primes), padded to a multiple of 4
    bytes (whole 32-bit words; no kernel reads or writes the padding)."""
    return (sum(int(p) for p in primes) + 3) // 4 * 4


class ByteTables(tuple):
    """The T byte tables of a sketch: views of exactly p_t bytes (what
    save and load write) into one flat u8 buffer, ``flat``, that joins
    them end to end as JAX's v2 path does (sketch_kernels.py:501-502,
    526-529). The kernels take the flat buffer and 64-bit indices."""

    def __new__(cls, flat, primes):
        views = [flat[o:o + int(p)]
                 for o, p in zip(byte_offsets(primes), primes)]
        obj = super().__new__(cls, views)
        obj.flat = flat
        return obj


def byte_update_plain(primes, flat, n_unique, hashes, nvalid,
                      with_bigcount=False, with_event_new=False):
    """Exact byte update of hashes[:nvalid] in stream order, in place
    (plain PyTorch, any device).

    The contract of every JAX byte path (v2 :496-577, image :264-341, sort
    :137-164 with _dedup_batch, make_update :600-646), for the T prime
    tables joined in `flat`:
      * each counter table_t[h % p_t] becomes min(old + occurrences in the
        chunk, 255);
      * n_unique (i64 [1]) grows by the unique hashes that are new: a hash
        is new iff its first event is the lowest-index event of the chunk
        to touch some counter whose value before the chunk was 0.
    It is exact at any chunk and table size, so JAX's collision budget and
    sticky overflow flag (:382-418, :460-493), artifacts of its fixed-size
    XLA sort, have no counterpart; nor do the image and i32 gates.

    With bigcount, returns the report (cand_hash i64 [n], cand_old i32
    [n], n_cand i32 [1]): each event whose counters are all 255 after the
    chunk, with its least counter before the chunk, in no fixed order;
    bigcount_triggers turns it into per-hash triggers. Else None.

    With with_event_new, returns (that report or None, flags bool
    [nvalid]): each event's new flag, JAX's event_new (sketch_kernels.py
    :559-561), the first event of each hash that is new.
    """
    n = int(nvalid)
    dev = flat.device
    h = hashes[:n]
    idx = torch.arange(n, device=dev)
    fresh = torch.zeros(n, dtype=torch.bool, device=dev)
    min_old = torch.full((n,), MAX_KCOUNT, dtype=torch.int32, device=dev)
    counters = []
    for off, p in zip(byte_offsets(primes), primes):
        c = umod(h, p) + off
        old = flat[c].to(torch.int32)
        uc, inv, cnt = torch.unique(c, return_inverse=True,
                                    return_counts=True)
        first = torch.full(uc.shape, n, dtype=torch.int64,
                           device=dev).scatter_reduce_(0, inv, idx, "amin")
        fresh |= (first[inv] == idx) & (old == 0)
        min_old = torch.minimum(min_old, old)
        flat[uc] = (flat[uc].to(torch.int32) + cnt).clamp_(
            max=MAX_KCOUNT).to(torch.uint8)
        counters.append(c)
    n_unique += fresh.sum()
    report = None
    if with_bigcount:
        post = torch.stack([flat[c] for c in counters]).amin(dim=0)
        cand = post == MAX_KCOUNT
        cand_hash = h[cand]
        report = (cand_hash, min_old[cand],
                  torch.tensor([cand_hash.shape[0]], dtype=torch.int32,
                               device=dev))
    return (report, fresh) if with_event_new else report


def bigcount_triggers(cand_hash, cand_old):
    """{hash: triggers > 0} from an update's bigcount report (numpy u64
    hashes and least pre-chunk counters of the candidate events):
    triggers = events - max(0, 255 - min_old) per hash, the rule of the
    JAX image path (khmer_tpu/core/sketch.py:267-295), equal to v2's
    ucnt - max(255 - min_old, 0). Every event of a hash has the same
    counters, so the same min_old."""
    hs = np.asarray(cand_hash, dtype=np.uint64)
    if hs.size == 0:
        return {}
    ms = np.asarray(cand_old, dtype=np.int64)
    uh, first, cnt = np.unique(hs, return_index=True, return_counts=True)
    trig = cnt - np.maximum(0, MAX_KCOUNT - ms[first])
    keep = trig > 0
    return {int(h): int(t) for h, t in zip(uh[keep], trig[keep])}


# --------------------------------------------------------------------------
# the update kernels' scratch (csrc/bucket_common.cuh)
# --------------------------------------------------------------------------

# The update kernels bucket a chunk's lane-events (one counter of one
# event, named by a 32-bit id) by counter range, about BUCKET_TARGET to a
# bucket and at most MAX_BUCKETS buckets (csrc/bucket_common.cuh
# kMaxBuckets); a chunk holds fewer than MAX_LANE_EVENTS of them.
BUCKET_TARGET = 512
MAX_BUCKETS = 16384
MAX_LANE_EVENTS = 2**31

_PLAN_PARTS = ("ids", "start", "cursor", "ev_word", "min_old")


def update_plan(n, ntables):
    """The scratch of one update of n events of `ntables` counters each:
    (nbuckets, {part: (byte offset, bytes)}, total bytes), parts in the
    order of _PLAN_PARTS, each 8-byte aligned: the lane-event ids (4 bytes
    each), the bucket starts and cursors (4 bytes per bucket), and two
    4-byte words per event (its flag word, and the least old counter of
    the bigcount report or, in kernel J, its probe's lane mask). It
    depends on the chunk alone, never on the table."""
    n, ntables = int(n), int(ntables)
    lanes = n * ntables
    if lanes >= MAX_LANE_EVENTS:
        raise ValueError("chunk too large: %d events x %d counters (the "
                         "update takes fewer than %d)"
                         % (n, ntables, MAX_LANE_EVENTS))
    nbuckets = min(max(-(-lanes // BUCKET_TARGET), 1), MAX_BUCKETS)
    sizes = (4 * lanes, 4 * (nbuckets + 1), 4 * nbuckets, 4 * n, 4 * n)
    parts, off = {}, 0
    for name, size in zip(_PLAN_PARTS, sizes):
        parts[name] = (off, size)
        off += -(-size // 8) * 8
    return nbuckets, parts, off


def bucket_of(index, size, nbuckets):
    """The bucket of flat counter `index` (< size), as the kernels compute
    it: floor(index * q * nbuckets / 2^64) with q = (2^64 - 1) // size.
    Monotone in index, so each bucket is one contiguous range."""
    q = (2**64 - 1) // size
    return (index * q * nbuckets) >> 64


def update_scratch(buf, n, ntables, device):
    """A uint8 buffer for update_plan(n, ntables) on `device`: `buf` when
    it is one and large enough (a sketch keeps its buffer between
    chunks), else a new one from torch.empty."""
    return _scratch_buffer(buf, update_plan(n, ntables)[2], device)


def _scratch_buffer(buf, need, device):
    """`buf` when it is an 8-byte aligned uint8 buffer of at least `need`
    bytes on `device`, else a new one from torch.empty."""
    if (buf is not None and buf.device == device
            and buf.dtype == torch.uint8 and buf.dim() == 1
            and buf.is_contiguous() and buf.data_ptr() % 8 == 0
            and buf.numel() >= need):
        return buf
    return torch.empty(max(need, 8), dtype=torch.uint8, device=device)


def _scratch_ptrs(buf, n, ntables):
    """(nbuckets, [device address of each part]) of a scratch buffer."""
    nbuckets, parts, _ = update_plan(n, ntables)
    base = buf.data_ptr()
    return nbuckets, [base + parts[name][0] for name in _PLAN_PARTS]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev):
    """The raw handle of `dev`'s current stream, for a C entry point: the
    same as torch.cuda.current_stream(dev).cuda_stream, without building a
    Stream object (several microseconds a launch). A private torch call:
    tests/test_torch_gpu_kernels.py holds it to the public one."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _layout(primes, bits=False, nibbles=False):
    """Host int64 arrays of the primes and of the tables' offsets for a C
    entry point: in bytes (the byte layout), with `bits` in bits (the bit
    layout) or with `nibbles` in nibbles (the nibble layout), made once
    for each set of primes (the entry points copy them)."""
    return _layout_arrays(tuple(int(p) for p in primes), bits, nibbles)


@functools.lru_cache(maxsize=16)
def _layout_arrays(primes, bits, nibbles=False):
    arr = ctypes.c_int64 * len(primes)
    if bits:
        offsets = [8 * o for o in bit_offsets(primes)]
    elif nibbles:
        offsets = [2 * o for o in nibble_offsets(primes)]
    else:
        offsets = byte_offsets(primes)
    return (arr(*primes), arr(*offsets))


def _check_byte_args(primes, flat, hashes):
    _check_byte_layout(primes, flat)
    if hashes.device != flat.device:
        raise ValueError("table and hashes must be on %s" % flat.device)
    if hashes.dtype != torch.int64 or hashes.dim() != 1 \
            or not hashes.is_contiguous():
        raise ValueError("hashes must be a contiguous 1-D int64 tensor")


def _check_byte_layout(primes, flat):
    dev = flat.device
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors, not %s" % dev)
    if not 1 <= len(primes) <= MAX_TABLES:
        raise ValueError("the byte kernels take 1 to %d tables, not %d"
                         % (MAX_TABLES, len(primes)))
    if (flat.dtype != torch.uint8 or flat.dim() != 1
            or not flat.is_contiguous()
            or flat.shape[0] != byte_flat_size(primes)):
        raise ValueError("flat must be the contiguous uint8 buffer of "
                         "byte_flat_size(primes) = %d bytes"
                         % byte_flat_size(primes))


def byte_update_cuda(primes, flat, n_unique, hashes, nvalid,
                     with_bigcount=False, scratch=None, with_event_new=False):
    """Kernel A (csrc/byte_update.cu): byte_update_plain on the card.

    `scratch` is a uint8 buffer on the card of at least
    update_plan(nvalid, T) bytes (update_scratch; a sketch keeps one
    between chunks), or None for a new one: nothing the size of the
    tables. Returns the bigcount report as device tensors (its count read
    by nobody here), or None; with with_event_new, (that, the new flags
    bool [nvalid]). Counts its launches in ``byte_update_cuda.launches``.
    """
    dev = flat.device
    _check_byte_args(primes, flat, hashes)
    n = int(nvalid)
    if not 0 <= n <= hashes.shape[0]:
        raise ValueError("nvalid %d outside [0, %d]" % (n, hashes.shape[0]))
    if (n_unique.device != dev or n_unique.dtype != torch.int64
            or n_unique.numel() != 1):
        raise ValueError("n_unique must be an int64 [1] tensor on %s" % dev)
    # held until the launch: the allocator may not hand it out meanwhile
    scratch = update_scratch(scratch, n, len(primes), dev)
    nbuckets, ptr = _scratch_ptrs(scratch, n, len(primes))
    report = None
    if with_bigcount:
        report = (torch.empty(n, dtype=torch.int64, device=dev),
                  torch.empty(n, dtype=torch.int32, device=dev),
                  torch.zeros(1, dtype=torch.int32, device=dev))
    flags = None
    if with_event_new:
        flags = torch.empty(n, dtype=torch.bool, device=dev)
    out = (report, flags) if with_event_new else report
    if n == 0:
        return out
    primes_arr, offsets_arr = _layout(primes)
    cand_hash, cand_old, n_cand = report or (None, None, None)
    err = cuda.library().khmer_byte_update(
        flat.data_ptr(), flat.shape[0], len(primes),
        ctypes.addressof(primes_arr), ctypes.addressof(offsets_arr),
        hashes.data_ptr(), n, nbuckets, *ptr, n_unique.data_ptr(),
        _ptr(cand_hash), _ptr(cand_old), _ptr(n_cand), _ptr(flags),
        dev.index, _stream(dev))
    cuda.check(err, "byte_update")
    byte_update_cuda.launches += 1
    return out


byte_update_cuda.launches = 0


def byte_update(primes, flat, n_unique, hashes, nvalid,
                with_bigcount=False, scratch=None, with_event_new=False):
    """Exact byte update of hashes[:nvalid], in place: kernel A on a CUDA
    buffer (with the sketch's `scratch`, see byte_update_cuda), the plain
    version on a CPU one. Returns the bigcount report or None and, with
    with_event_new, the new flags (see byte_update_plain)."""
    if flat.is_cuda:
        return byte_update_cuda(primes, flat, n_unique, hashes, nvalid,
                                with_bigcount, scratch, with_event_new)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return byte_update_plain(primes, flat, n_unique, hashes, nvalid,
                             with_bigcount, with_event_new)


def byte_gather_plain(primes, flat, hashes):
    """Min over the T tables of table_t[h % p_t], for a hash tensor of any
    shape -> int32 (plain PyTorch, any device)."""
    counts = torch.full(hashes.shape, MAX_KCOUNT, dtype=torch.int32,
                        device=hashes.device)
    for off, p in zip(byte_offsets(primes), primes):
        counts = torch.minimum(counts,
                               flat[umod(hashes, p) + off].to(torch.int32))
    return counts


def byte_gather_cuda(primes, flat, hashes):
    """Kernel B (csrc/byte_gather.cu): byte_gather_plain of a 1-D int64
    hash tensor -> int32 [n]. Counts its launches in
    ``byte_gather_cuda.launches``."""
    dev = flat.device
    _check_byte_args(primes, flat, hashes)
    n = hashes.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    primes_arr, offsets_arr = _layout(primes)
    err = cuda.library().khmer_byte_gather(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), hashes.data_ptr(), n, out.data_ptr(),
        dev.index, _stream(dev))
    cuda.check(err, "byte_gather")
    byte_gather_cuda.launches += 1
    return out


byte_gather_cuda.launches = 0


def byte_gather(primes, flat, hashes):
    """Counts of a hash tensor (any shape) -> int32: kernel B on a CUDA
    buffer, the plain version on a CPU one."""
    if flat.is_cuda:
        flat_h = hashes.reshape(-1).contiguous()
        return byte_gather_cuda(primes, flat, flat_h).reshape(hashes.shape)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return byte_gather_plain(primes, flat, hashes)


def byte_pertable_plain(primes, flat, hashes):
    """Every table's counter table_t[h % p_t] of a 1-D hash tensor ->
    uint8 [T, n] (plain PyTorch, any device)."""
    return torch.stack([flat[umod(hashes, p) + off]
                        for off, p in zip(byte_offsets(primes), primes)])


def byte_pertable_cuda(primes, flat, hashes):
    """Kernel M (csrc/byte_gather.cu): byte_pertable_plain of a 1-D int64
    hash tensor -> uint8 [T, n]. Counts its launches in
    ``byte_pertable_cuda.launches``."""
    dev = flat.device
    _check_byte_args(primes, flat, hashes)
    n = hashes.shape[0]
    out = torch.empty((len(primes), n), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    primes_arr, offsets_arr = _layout(primes)
    err = cuda.library().khmer_byte_pertable(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), hashes.data_ptr(), n, out.data_ptr(),
        dev.index, _stream(dev))
    cuda.check(err, "byte_pertable")
    byte_pertable_cuda.launches += 1
    return out


byte_pertable_cuda.launches = 0


def byte_pertable(primes, flat, hashes):
    """Every table's counter of a 1-D int64 hash tensor -> uint8 [T, n]:
    kernel M on a CUDA buffer, the plain version on a CPU one."""
    if flat.is_cuda:
        return byte_pertable_cuda(primes, flat, hashes)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return byte_pertable_plain(primes, flat, hashes)


# bytes of a table that byte_occupied counts at a time
OCCUPIED_SLICE = 1 << 22


def byte_occupied(table0):
    """Nonzero counters of a byte table (a device scalar), counted a slice
    of OCCUPIED_SLICE bytes at a time, so that the count's temporaries
    follow the slice and not the table: one pass over the 1 GB table 0 of
    -x 1e9 -N 4 raised the peak device memory by 9 GB on an H100."""
    total = torch.zeros((), dtype=torch.int64, device=table0.device)
    for lo in range(0, table0.shape[0], OCCUPIED_SLICE):
        total += (table0[lo:lo + OCCUPIED_SLICE] != 0).sum()
    return total


# --------------------------------------------------------------------------
# the nibble layout (NibbleStorage, reference storage.hh:245-405): the
# update (kernel P), the count gather (Q) and the per-table gather (R)
# --------------------------------------------------------------------------

NIBBLE_MAX = 15  # a 4-bit counter saturates here


def nibble_table_bytes(prime):
    """Bytes of one nibble table of `prime` counters, as khmer stores it."""
    return int(prime) // 2 + 1


def nibble_offsets(primes):
    """Start (in bytes) of each nibble table in the joined buffer."""
    return [int(o) for o in np.cumsum(
        [0] + [nibble_table_bytes(p) for p in primes[:-1]])]


def nibble_flat_size(primes):
    """Length of the joined nibble buffer: the tables' bytes, padded to
    whole 32-bit words (kernel P reads and stores whole words; the
    padding's bits are stored as they were read)."""
    return (sum(nibble_table_bytes(p) for p in primes) + 3) // 4 * 4


class NibbleTables(tuple):
    """The T nibble tables of a SmallCountgraph: views of exactly
    p_t // 2 + 1 bytes (what save and load write) into one flat u8
    buffer, ``flat``. Counter b of table t is the high nibble of its byte
    b // 2 for an even b, the low one for an odd b, so flat nibble
    2 * offset_t + b (even: high): kernel P names every counter of the
    sketch by one 64-bit index into the flat buffer."""

    def __new__(cls, flat, primes):
        views = [flat[o:o + nibble_table_bytes(p)]
                 for o, p in zip(nibble_offsets(primes), primes)]
        obj = super().__new__(cls, views)
        obj.flat = flat
        return obj


# Kernel P's scratch (csrc/nibble_update.cu): its own plan, not
# update_plan's. It buckets a chunk's records by 32-bit word, about
# NIBBLE_BUCKET_TARGET records to a bucket (a bucket block holds 4,096),
# at least NIBBLE_MIN_BUCKETS and at most NIBBLE_MAX_BUCKETS buckets
# (kMaxBuckets); a record keeps its event in 28 bits and its offset in its
# bucket in 32, so a chunk has fewer than NIBBLE_MAX_EVENTS events and a
# bucket spans at most NIBBLE_MAX_SPAN_WORDS words.
NIBBLE_BUCKET_TARGET = 3584
NIBBLE_MIN_BUCKETS = 64
NIBBLE_MAX_BUCKETS = 8192
NIBBLE_MAX_EVENTS = 2**28
NIBBLE_MAX_SPAN_WORDS = 2**29
# its count and scatter tiles: a block of NIBBLE_TILE_THREADS stages at most
# NIBBLE_STAGE records (csrc kTileThreads, kStage)
NIBBLE_TILE_THREADS = 256
NIBBLE_STAGE = 6144

_NIBBLE_PARTS = ("recs", "counts", "start", "offsets", "flags")


def nibble_tiles(n, ntables):
    """Kernel P's count and scatter tiles for n events of `ntables`
    counters: (tiles, events a tile), as the kernel cuts them: per_thread
    events for each of a block's NIBBLE_TILE_THREADS threads, the most that
    keep a tile's records within NIBBLE_STAGE; or, with more tables than
    that allows, one event for each of the first (NIBBLE_STAGE // ntables)
    rounded down to 32 threads."""
    n, ntables = int(n), int(ntables)
    if NIBBLE_TILE_THREADS * ntables <= NIBBLE_STAGE:
        per_tile = (NIBBLE_STAGE // (NIBBLE_TILE_THREADS * ntables)
                    * NIBBLE_TILE_THREADS)
    else:
        per_tile = NIBBLE_STAGE // ntables // 32 * 32
    return -(-n // per_tile), per_tile


def nibble_update_plan(n, ntables):
    """Kernel P's scratch for n events of `ntables` counters each:
    (nbuckets, {part: (byte offset, bytes)}, total bytes), parts in the
    order of _NIBBLE_PARTS, each 8-byte aligned: a 64-bit record a
    lane-event, the bucket counts (4 bytes a bucket), the bucket starts
    (nbuckets + 1), each tile's place in each bucket (4 bytes a tile and
    bucket, nibble_tiles) and a flag byte an event (rounded up to whole
    words; used where the caller wants no flags). It depends on the chunk
    alone, never on the tables."""
    n, ntables = int(n), int(ntables)
    lanes = n * ntables
    if n >= NIBBLE_MAX_EVENTS or lanes >= MAX_LANE_EVENTS:
        raise ValueError("chunk too large: %d events x %d counters (the "
                         "nibble update takes fewer than %d events and %d "
                         "lane-events)" % (n, ntables, NIBBLE_MAX_EVENTS,
                                           MAX_LANE_EVENTS))
    nbuckets = min(max(-(-lanes // NIBBLE_BUCKET_TARGET), NIBBLE_MIN_BUCKETS),
                   NIBBLE_MAX_BUCKETS)
    tiles = nibble_tiles(n, ntables)[0]
    sizes = (8 * lanes, 4 * nbuckets, 4 * (nbuckets + 1),
             4 * tiles * nbuckets, -(-n // 4) * 4)
    parts, off = {}, 0
    for name, size in zip(_NIBBLE_PARTS, sizes):
        parts[name] = (off, size)
        off += -(-size // 8) * 8
    return nbuckets, parts, off


def nibble_buckets(size, nbuckets):
    """(span, used) of kernel P's buckets over a flat buffer of `size`
    bytes: bucket b holds 32-bit words [b * span, (b + 1) * span), span =
    ceil(words / nbuckets), and `used` = ceil(words / span) <= nbuckets of
    them hold a word. Raises where a bucket's nibble offsets would not fit
    a record's 32 bits (beyond 128 GiB at NIBBLE_MIN_BUCKETS)."""
    words = int(size) // 4
    span = -(-words // int(nbuckets))
    if span > NIBBLE_MAX_SPAN_WORDS:
        raise ValueError("nibble tables of %d bytes too large for %d "
                         "buckets" % (size, nbuckets))
    return span, -(-words // span)


def nibble_update_scratch(buf, n, ntables, device):
    """A uint8 buffer for nibble_update_plan(n, ntables) on `device`: `buf`
    when it is one and large enough (a SmallCountgraph keeps its buffer
    between chunks), else a new one from torch.empty."""
    return _scratch_buffer(buf, nibble_update_plan(n, ntables)[2], device)


def _nibbles(flat, idx):
    """The 4-bit counters at flat nibble indices idx -> int32."""
    byte = flat[idx >> 1].to(torch.int32)
    return torch.where((idx & 1) == 1, byte & 0xF, byte >> 4)


def _set_nibbles(flat, idx, values):
    """Write values (< 16) to the distinct flat nibble indices idx, in
    place: the high nibbles first, then the low ones, each a
    read-modify-write of its byte, so two nibbles of one byte both land."""
    for odd, keep, shift in ((0, 0x0F, 4), (1, 0xF0, 0)):
        sel = (idx & 1) == odd
        b = idx[sel] >> 1
        flat[b] = ((flat[b].to(torch.int32) & keep)
                   | (values[sel].to(torch.int32) << shift)).to(torch.uint8)


def nibble_update_plain(primes, flat, n_unique, hashes, nvalid,
                        with_event_new=False):
    """Nibble Count-Min update of hashes[:nvalid] in stream order, in
    place (plain PyTorch, any device): JAX's _nibble_table_update
    (sketch_kernels.py:167-201, via _apply_update and make_update) for the
    T prime tables joined in `flat` (NibbleTables):
      * each counter becomes min(old + occurrences in the chunk, 15);
      * n_unique (i64 [1]) grows by the unique hashes that are new: a hash
        is new iff its first event is the lowest-index event of the chunk
        to touch some counter whose value before the chunk was 0 (JAX's
        per-parity credits, cred_e | cred_o, name the same events).
    No bigcount. With with_event_new, returns each event's new flag, bool
    [nvalid]; else None."""
    n = int(nvalid)
    dev = flat.device
    h = hashes[:n]
    idx = torch.arange(n, device=dev)
    fresh = torch.zeros(n, dtype=torch.bool, device=dev)
    for off, p in zip(nibble_offsets(primes), primes):
        c = umod(h, p) + 2 * off
        old = _nibbles(flat, c)
        uc, inv, cnt = torch.unique(c, return_inverse=True,
                                    return_counts=True)
        first = torch.full(uc.shape, n, dtype=torch.int64,
                           device=dev).scatter_reduce_(0, inv, idx, "amin")
        fresh |= (first[inv] == idx) & (old == 0)
        _set_nibbles(flat, uc, (_nibbles(flat, uc) + cnt).clamp_(
            max=NIBBLE_MAX))
    n_unique += fresh.sum()
    return fresh if with_event_new else None


def nibble_gather_plain(primes, flat, hashes, mask=None):
    """Min over the T nibble tables of each hash's counter, for a hash
    tensor of any shape -> int32, 15 where no table is lower (plain
    PyTorch, any device): JAX's _gather_counts, nibble branch (:660).
    With `mask` (bool, the shape of hashes), 0 where it is False."""
    counts = torch.full(hashes.shape, NIBBLE_MAX, dtype=torch.int32,
                        device=hashes.device)
    for off, p in zip(nibble_offsets(primes), primes):
        counts = torch.minimum(counts,
                               _nibbles(flat, umod(hashes, p) + 2 * off))
    return counts if mask is None else torch.where(mask, counts, 0)


def nibble_pertable_plain(primes, flat, hashes):
    """Every nibble table's counter of a 1-D hash tensor -> uint8 [T, n]
    (plain PyTorch, any device): JAX's make_pertable_get, nibble branch
    (:692)."""
    return torch.stack([
        _nibbles(flat, umod(hashes, p) + 2 * off).to(torch.uint8)
        for off, p in zip(nibble_offsets(primes), primes)])


def nibble_pertable_rows_plain(primes, flat, codes, lengths, k):
    """Kernel R's rows mode (plain PyTorch, any device): for rows of 2-bit
    codes [B, L] with lengths [B] and k-mers of k (1-32, the twobit
    family), (hashes int64 [B, W], counters uint8 [T, B, W], index int64
    [T, B, W]) with W = L - k + 1: on each valid window (w <= length - k)
    its canonical hash, each table's counter of it and the flat nibble
    index it lies at, 2 * nibble_offsets[t] + hash % primes[t] (disjoint
    across tables, so it numbers the window's (table, counter) pairs);
    hash 0, counter 0 and index -1 elsewhere. JAX's make_pertable_counts,
    nibble branch (khmer_tpu/core/diginorm.py:51), on the valid windows."""
    hashes, valid, _ = _window_hashes(codes, lengths, k)
    index = torch.stack([torch.where(valid, umod(hashes, p) + 2 * off, -1)
                         for off, p in zip(nibble_offsets(primes), primes)])
    counters = torch.where(valid, _nibbles(flat, index.clamp(min=0)), 0)
    return (torch.where(valid, hashes, 0), counters.to(torch.uint8), index)


def nibble_row_counts_plain(primes, flat, codes, lengths, k):
    """Kernel Q's rows mode (plain PyTorch, any device): uint8 [B, L - k +
    1], each valid window's least counter over the nibble tables, 0 past a
    read's windows. JAX's make_hash_batch then _get_fn on nibble tables
    (khmer_tpu/core/pipeline.py:503)."""
    hashes, valid, _ = _window_hashes(codes, lengths, k)
    return nibble_gather_plain(primes, flat, hashes, valid).to(torch.uint8)


def _check_nibble_layout(primes, flat):
    dev = flat.device
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors, not %s" % dev)
    if not 1 <= len(primes) <= MAX_TABLES:
        raise ValueError("the nibble kernels take 1 to %d tables, not %d"
                         % (MAX_TABLES, len(primes)))
    if (flat.dtype != torch.uint8 or flat.dim() != 1
            or not flat.is_contiguous() or flat.data_ptr() % 4 != 0
            or flat.shape[0] != nibble_flat_size(primes)):
        raise ValueError("flat must be the contiguous, 4-byte aligned "
                         "uint8 buffer of nibble_flat_size(primes) = %d "
                         "bytes" % nibble_flat_size(primes))


def _check_nibble_args(primes, flat, hashes):
    _check_nibble_layout(primes, flat)
    dev = flat.device
    if hashes.device != dev or hashes.dtype != torch.int64 \
            or hashes.dim() != 1 or not hashes.is_contiguous():
        raise ValueError("hashes must be a contiguous 1-D int64 tensor on %s"
                         % dev)


def nibble_update_cuda(primes, flat, n_unique, hashes, nvalid, scratch=None,
                       with_event_new=False):
    """Kernel P (csrc/nibble_update.cu): nibble_update_plain on the card.
    `scratch` is a uint8 buffer of at least nibble_update_plan(nvalid, T)
    bytes on the card (nibble_update_scratch; sized by the chunk, never by
    the tables), or None for a new one. Returns the new flags, bool
    [nvalid], with with_event_new; else None. Counts its launches in
    ``nibble_update_cuda.launches``."""
    dev = flat.device
    _check_nibble_args(primes, flat, hashes)
    n = int(nvalid)
    if not 0 <= n <= hashes.shape[0]:
        raise ValueError("nvalid %d outside [0, %d]" % (n, hashes.shape[0]))
    if (n_unique.device != dev or n_unique.dtype != torch.int64
            or n_unique.numel() != 1):
        raise ValueError("n_unique must be an int64 [1] tensor on %s" % dev)
    if n == 0:
        return (torch.empty(0, dtype=torch.bool, device=dev)
                if with_event_new else None)
    # held until the launch: the allocator may not hand it out meanwhile
    scratch = nibble_update_scratch(scratch, n, len(primes), dev)
    nbuckets, parts, _ = nibble_update_plan(n, len(primes))
    base = scratch.data_ptr()
    # the kernel counts the flags a 32-bit word at a time: whole words
    flags = (torch.empty(-(-n // 4) * 4, dtype=torch.bool, device=dev)
             if with_event_new else None)
    flag_ptr = (flags.data_ptr() if flags is not None
                else base + parts["flags"][0])
    primes_arr, offsets_arr = _layout(primes, nibbles=True)
    err = cuda.library().khmer_nibble_update(
        flat.data_ptr(), flat.shape[0], len(primes),
        ctypes.addressof(primes_arr), ctypes.addressof(offsets_arr),
        hashes.data_ptr(), n, nbuckets, nibble_tiles(n, len(primes))[0],
        *[base + parts[name][0] for name in _NIBBLE_PARTS[:4]], flag_ptr,
        n_unique.data_ptr(), dev.index, _stream(dev))
    cuda.check(err, "nibble_update")
    nibble_update_cuda.launches += 1
    return flags[:n] if flags is not None else None


nibble_update_cuda.launches = 0


def nibble_update(primes, flat, n_unique, hashes, nvalid, scratch=None,
                  with_event_new=False):
    """Nibble update of hashes[:nvalid], in place: kernel P on a CUDA
    buffer, the plain version on a CPU one. Returns the new flags with
    with_event_new, else None."""
    if flat.is_cuda:
        return nibble_update_cuda(primes, flat, n_unique, hashes, nvalid,
                                  scratch, with_event_new)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return nibble_update_plain(primes, flat, n_unique, hashes, nvalid,
                               with_event_new)


def nibble_gather_cuda(primes, flat, hashes, mask=None):
    """Kernel Q (csrc/nibble_gather.cu): nibble_gather_plain of a 1-D
    int64 hash tensor -> int32 [n]; with `mask` (bool [n]), a masked-off
    hash loads nothing and counts 0. Counts its launches in
    ``nibble_gather_cuda.launches``."""
    dev = flat.device
    n = hashes.shape[0]
    if mask is not None and (mask.device != dev or mask.dtype != torch.bool
                             or tuple(mask.shape) != (n,)
                             or not mask.is_contiguous()):
        raise ValueError("mask must be a contiguous bool [%d] tensor on %s"
                         % (n, dev))
    _check_nibble_args(primes, flat, hashes)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    primes_arr, offsets_arr = _layout(primes, nibbles=True)
    err = cuda.library().khmer_nibble_gather(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), hashes.data_ptr(), n, _ptr(mask),
        out.data_ptr(), dev.index, _stream(dev))
    cuda.check(err, "nibble_gather")
    nibble_gather_cuda.launches += 1
    return out


nibble_gather_cuda.launches = 0


def nibble_gather(primes, flat, hashes, mask=None):
    """Counts of a hash tensor (any shape) in nibble tables -> int32, 0
    where the optional bool `mask` (the shape of hashes) is False: kernel
    Q on a CUDA buffer, the plain version on a CPU one."""
    if flat.is_cuda:
        flat_m = None if mask is None else mask.reshape(-1).contiguous()
        return nibble_gather_cuda(primes, flat,
                                  hashes.reshape(-1).contiguous(),
                                  flat_m).reshape(hashes.shape)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return nibble_gather_plain(primes, flat, hashes, mask)


def nibble_pertable_cuda(primes, flat, hashes):
    """Kernel R (csrc/nibble_gather.cu): nibble_pertable_plain of a 1-D
    int64 hash tensor -> uint8 [T, n]. Counts its launches in
    ``nibble_pertable_cuda.launches``."""
    dev = flat.device
    _check_nibble_args(primes, flat, hashes)
    n = hashes.shape[0]
    out = torch.empty((len(primes), n), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    primes_arr, offsets_arr = _layout(primes, nibbles=True)
    err = cuda.library().khmer_nibble_pertable(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), hashes.data_ptr(), n, out.data_ptr(),
        dev.index, _stream(dev))
    cuda.check(err, "nibble_pertable")
    nibble_pertable_cuda.launches += 1
    return out


nibble_pertable_cuda.launches = 0


def nibble_pertable(primes, flat, hashes):
    """Every nibble table's counter of a 1-D int64 hash tensor -> uint8
    [T, n]: kernel R on a CUDA buffer, the plain version on a CPU one."""
    if flat.is_cuda:
        return nibble_pertable_cuda(primes, flat, hashes)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return nibble_pertable_plain(primes, flat, hashes)


def _nibble_rows_launch(name, primes, flat, codes, lengths, k, *outs):
    """Launch a rows mode of csrc/nibble_gather.cu (`name`) over codes
    [R, L] / lengths [R], tiled by kernel H's read_plan."""
    dev = flat.device
    R, L = codes.shape
    plan = read_plan(L, k)
    primes_arr, offsets_arr = _layout(primes, nibbles=True)
    err = getattr(cuda.library(), name)(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), codes.data_ptr(), lengths.data_ptr(),
        R, L, int(k), plan["rows"], plan["seg"],
        *[t.data_ptr() for t in outs], dev.index, _stream(dev))
    cuda.check(err, name)


def nibble_pertable_rows_cuda(primes, flat, codes, lengths, k):
    """Kernel R's rows mode (csrc/nibble_gather.cu
    khmer_nibble_pertable_rows): nibble_pertable_rows_plain on the card,
    each window hashed from the codes in the kernel. Counts its launches
    in ``nibble_pertable_rows_cuda.launches``."""
    dev = flat.device
    _check_rows(codes, lengths, k, dev)
    _check_nibble_layout(primes, flat)
    R, L = codes.shape
    W = L - int(k) + 1
    hashes = torch.empty((R, W), dtype=torch.int64, device=dev)
    counters = torch.empty((len(primes), R, W), dtype=torch.uint8,
                           device=dev)
    index = torch.empty((len(primes), R, W), dtype=torch.int64, device=dev)
    if R == 0:
        return hashes, counters, index
    _nibble_rows_launch("khmer_nibble_pertable_rows", primes, flat, codes,
                        lengths, k, hashes, counters, index)
    nibble_pertable_rows_cuda.launches += 1
    return hashes, counters, index


nibble_pertable_rows_cuda.launches = 0


def nibble_pertable_rows(primes, flat, codes, lengths, k):
    """(hashes [B, W], counters uint8 [T, B, W], flat nibble index [T, B,
    W]) of each valid window of a [B, L] code matrix, the fill elsewhere
    (nibble_pertable_rows_plain): kernel R's rows mode on a CUDA buffer,
    the plain version on a CPU one."""
    if flat.is_cuda:
        return nibble_pertable_rows_cuda(primes, flat, codes, lengths, k)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return nibble_pertable_rows_plain(primes, flat, codes, lengths, k)


def nibble_row_counts_cuda(primes, flat, codes, lengths, k):
    """Kernel Q's rows mode (csrc/nibble_gather.cu khmer_nibble_row_counts):
    nibble_row_counts_plain on the card -> uint8 [R, L - k + 1]. Counts its
    launches in ``nibble_row_counts_cuda.launches``."""
    dev = flat.device
    _check_rows(codes, lengths, k, dev)
    _check_nibble_layout(primes, flat)
    R, L = codes.shape
    counts = torch.empty((R, L - int(k) + 1), dtype=torch.uint8, device=dev)
    if R == 0:
        return counts
    _nibble_rows_launch("khmer_nibble_row_counts", primes, flat, codes,
                        lengths, k, counts)
    nibble_row_counts_cuda.launches += 1
    return counts


nibble_row_counts_cuda.launches = 0


def nibble_row_counts(primes, flat, codes, lengths, k):
    """Each valid window's least counter in nibble tables, uint8 [B, L - k
    + 1], 0 elsewhere: kernel Q's rows mode on a CUDA buffer, the plain
    version on a CPU one."""
    if flat.is_cuda:
        return nibble_row_counts_cuda(primes, flat, codes, lengths, k)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return nibble_row_counts_plain(primes, flat, codes, lengths, k)


def nibble_occupied(table0):
    """Nonzero nibbles of a nibble table (a device scalar), counted a
    slice of OCCUPIED_SLICE bytes at a time, as byte_occupied: JAX's
    make_nibble_occupied (:768), whose count takes in the unused low
    nibble of an odd prime's last byte, which stays 0."""
    total = torch.zeros((), dtype=torch.int64, device=table0.device)
    for lo in range(0, table0.shape[0], OCCUPIED_SLICE):
        s = table0[lo:lo + OCCUPIED_SLICE]
        total += ((s >> 4) != 0).sum() + ((s & 0xF) != 0).sum()
    return total


# --------------------------------------------------------------------------
# diginorm: the median test (kernel E) and the keep/consume scan (kernel F)
# --------------------------------------------------------------------------

# A window is B bundles of at most two reads: rows 2b and 2b + 1 of a
# [2B, L] uint8 matrix of 2-bit codes, with their lengths (int32 [2B]; 0
# for an absent read). A read is present iff its length is >= k, and its
# windows j < length - k + 1 are valid.


def _window_hashes(codes, lengths, k):
    """(hashes [2B, W] int64, valid [2B, W] bool, nvalid [2B] int64) of a
    window's reads: the canonical 2-bit hash of every k-window, which of
    them lie inside their read, and max(length - k + 1, 0)."""
    L = codes.shape[-1]
    W = L - k + 1
    hashes = rolling_hash_windows(codes, k)[0]
    lengths = lengths.to(torch.int64)
    win = torch.arange(W, device=codes.device)
    valid = win[None, :] <= (lengths[:, None] - k)
    return hashes, valid, torch.clamp(lengths - (k - 1), min=0)


def _min_required(nvalid):
    """median_at_least's threshold floor(0.5 + nvalid / 2), in float32 as
    the reference computes it (hashtable.cc:333-364)."""
    return torch.floor(0.5 + nvalid.to(torch.float32) / 2.0).to(torch.int64)


def med_ok_plain(primes, k, cutoff, flat, codes, lengths):
    """Phase A of diginorm (JAX diginorm_scan.make_med_ok; plain PyTorch,
    any device): bool [B], True iff every present read of bundle b has
    median_at_least(cutoff) under the tables as they stand, i.e. the
    bundle is rejected. Counts are min(count, 255) over the tables."""
    hashes, valid, nvalid = _window_hashes(codes, lengths, k)
    counts = byte_gather_plain(primes, flat, hashes)
    ge = (valid & (counts >= int(cutoff))).sum(dim=1)
    ok = (ge >= _min_required(nvalid)) | (lengths < k)
    return ok.reshape(-1, 2).all(dim=1)


# Kernel E (csrc/diginorm_med.cu): blocks of MED_THREADS threads, each
# taking a tile of rows (whole bundles), at most MED_MAX_ROWS, in segments
# of at most MED_SEG windows; these mirror its constants. MED_ROWS is the
# tile it is given where shared memory allows, MED_SMEM_LIMIT the dynamic
# shared memory it asks for at most (a block's 227 KB on the H100, less 2
# KB for its static shared words).
MED_THREADS = 256
MED_MAX_ROWS = 64
MED_ROWS = 32
MED_SEG = 1024
MED_SMEM_LIMIT = 227 * 1024 - 2048


@functools.lru_cache(maxsize=64)
def med_plan(L, k):
    """Kernel E's tiling for rows of L codes and k-mers of k: {"rows": rows
    a block (even), "seg": windows a segment (a multiple of 32),
    "bit_words": 32-bit words of window bits a row (0: the tables are
    loaded in one round), "smem": dynamic shared bytes}.

    Per row the block keeps a segment's packed codes, forward and reverse
    (16 B for each 32 codes of the segment's seg + 31, rounded up to
    words), a bit for each of the row's L - k + 1 windows and the row of
    each of a segment's items (1 B an item). It follows the window (L,
    k), never the tables."""
    L, k = int(L), int(k)
    if not 1 <= k <= 32 or L < k:
        raise ValueError("rows of %d codes hold no %d-mer" % (L, k))
    W = L - k + 1
    seg = min(-(-W // 32) * 32, MED_SEG)
    per_row = 16 * (seg // 32 + 1) + seg
    bit_words = -(-W // 32)
    rows = min(MED_ROWS,
               MED_SMEM_LIMIT // (per_row + 4 * bit_words) // 2 * 2)
    if rows < 2:
        bit_words = 0
        rows = min(MED_ROWS, MED_SMEM_LIMIT // per_row // 2 * 2)
    return {"rows": rows, "seg": seg, "bit_words": bit_words,
            "smem": rows * (per_row + 4 * bit_words)}


def med_load_plan(primes, k, cutoff, flat, codes, lengths):
    """Kernel E's rule for which counters it loads (plain PyTorch, any
    device): (reject bool [B], loaded bool [T, 2B, L - k + 1]), loaded[t,
    r, j] True iff the kernel loads table t's counter of window j of row r.

    Round 0 loads table 0 for every valid window. A present read whose
    windows with a table-0 count >= C are fewer than its threshold fails,
    and so does its bundle. Round 1 loads tables 1..T-1 for those surviving
    windows of every bundle that did not fail; a window counts iff every
    table's count is >= C. With one table, or rows whose window bits do not
    fit (med_plan's bit_words 0), one round loads every table for every
    valid window. The rejections equal med_ok_plain's."""
    hashes, valid, nvalid = _window_hashes(codes, lengths, k)
    C = int(cutoff)
    at = torch.stack([flat[umod(hashes, p) + o].to(torch.int32) >= C
                      for p, o in zip(primes, byte_offsets(primes))])
    need = _min_required(nvalid)
    present = lengths >= k
    T = len(primes)
    loaded = valid.expand(T, -1, -1).clone()
    if T > 1 and med_plan(codes.shape[1], k)["bit_words"]:
        survive = valid & at[0]
        fail = present & (survive.sum(dim=1) < need)
        failed = fail.reshape(-1, 2).any(dim=1)
        loaded[1:] = survive & ~failed.repeat_interleave(2)[:, None]
    ge = (valid & at.all(dim=0)).sum(dim=1)
    ok = (ge >= need) | ~present
    return ok.reshape(-1, 2).all(dim=1), loaded


def _consume_bundle(flat, n_unique, counters, old):
    """Commit one kept bundle (JAX diginorm_scan._consume_bundle), in
    place: counters [T, n] are the flat counters of its n events in stream
    order, old [T, n] their values before the bundle. Each counter becomes
    min(old + hits, 255); an event is new iff, in some table, its counter
    was 0 and it is the bundle's lowest event on that counter."""
    T, n = counters.shape
    event = torch.arange(n, device=flat.device).repeat(T)
    uc, inv, hits = torch.unique(counters.reshape(-1), return_inverse=True,
                                 return_counts=True)
    first = torch.full(uc.shape, n, dtype=torch.int64,
                       device=flat.device).scatter_reduce_(0, inv, event,
                                                           "amin")
    fresh = (first[inv] == event) & (old.reshape(-1) == 0)
    new = torch.zeros(n, dtype=torch.bool, device=flat.device)
    new[event[fresh]] = True
    n_unique += new.sum()
    flat[uc] = (flat[uc].to(torch.int32) + hits).clamp_(
        max=MAX_KCOUNT).to(torch.uint8)


# candidates whose counters diginorm_window_plain computes at once
_PLAIN_BLOCK = 512


def diginorm_window_plain(primes, k, cutoff, flat, n_unique, codes, lengths,
                          reject=None, n_cand=None, n_groups=None):
    """The diginorm keep/consume scan of one window, in stream order (JAX
    diginorm_scan.make_diginorm_window with _step_gather, _med_at_least
    and _consume_bundle; plain PyTorch, any device, a Python loop over
    bundles). Updates the u8 tables in `flat` and n_unique (int64 [1]) in
    place and returns keep, bool [B].

    A bundle is kept iff some present read fails median_at_least(cutoff)
    under the tables the earlier bundles left; a kept bundle adds +1 to the
    counter of each of its valid windows (read 0's, then read 1's) in each
    table, saturating at 255 (_consume_bundle). Bundles with `reject` set
    (kernel E's final rejections) are skipped: keep False, no test; the
    bundles tested are added to `n_cand` (int64 [1]) when given, and the
    groups kernel F forms of them (scan_groups) to `n_groups`. The
    bigcount map plays no part, as in the JAX scan.
    """
    hashes, valid, nvalid = _window_hashes(codes, lengths, k)
    B = codes.shape[0] // 2
    keep = torch.zeros(B, dtype=torch.bool, device=codes.device)
    # per read, on the host once: valid windows (a prefix of the row),
    # the test's threshold, presence
    nw = valid.sum(dim=1).tolist()
    min_req = _min_required(nvalid).tolist()
    present = (lengths >= k).tolist()
    if reject is None:
        cand = list(range(B))
    else:
        cand = torch.nonzero(~reject).flatten().tolist()
    if n_cand is not None:
        n_cand += len(cand)
    if n_groups is not None:
        nev = (valid[0::2].sum(dim=1) + valid[1::2].sum(dim=1)).tolist()
        n_groups += len(scan_groups(nev, cand, len(primes)))
    offsets = byte_offsets(primes)
    C = int(cutoff)
    for i, b in enumerate(cand):
        if i % _PLAIN_BLOCK == 0:
            # every window's counter in each table, for the next block of
            # candidates (they depend on the hashes alone)
            rows = torch.tensor(cand[i:i + _PLAIN_BLOCK],
                                device=codes.device)
            rows = torch.stack([2 * rows, 2 * rows + 1], dim=1).flatten()
            block = torch.stack([umod(hashes[rows], p) + o
                                 for p, o in zip(primes, offsets)])
        r0, r1 = 2 * b, 2 * b + 1
        n0 = nw[r0]
        j = 2 * (i % _PLAIN_BLOCK)
        # _step_gather: the bundle's events, their counters and counts
        counters = torch.cat([block[:, j, :n0], block[:, j + 1, :nw[r1]]],
                             dim=1)
        old = flat[counters]
        at_least = old.amin(dim=0).to(torch.int32) >= C
        ge0, ge1 = torch.stack([at_least[:n0].sum(),
                                at_least[n0:].sum()]).tolist()
        # _med_at_least: an absent read passes
        ok0 = not present[r0] or ge0 >= min_req[r0]
        ok1 = not present[r1] or ge1 >= min_req[r1]
        if ok0 and ok1:
            continue
        keep[b] = True
        _consume_bundle(flat, n_unique, counters, old)
    return keep


# Kernel F (csrc/diginorm_scan.cu): one block of DIGI_SCAN_THREADS threads
# walks the window in tiles of as many bundles. It takes a tile's
# candidates in groups whose (event, table) items fit DIGI_GROUP_ITEMS,
# half of its shared-memory overlay of DIGI_OVERLAY_SLOTS counters; a
# bundle with more items runs alone, its adds through a map of
# DIGI_MAP_SLOTS counters. These mirror its constants. DIGI_SMEM_LIMIT is
# the dynamic shared memory it asks for at most: a block's 227 KB on the
# H100, less 1 KB for its static shared words.
DIGI_SCAN_THREADS = 512
DIGI_OVERLAY_SLOTS = 8192
DIGI_GROUP_ITEMS = DIGI_OVERLAY_SLOTS // 2
DIGI_MAP_SLOTS = 4096
DIGI_SMEM_LIMIT = 227 * 1024 - 1024


def scan_groups(nev, cand, ntables):
    """Kernel F's groups: `cand` (candidate bundles, ascending) cut into
    consecutive lists, within each tile of DIGI_SCAN_THREADS bundles: from
    each group's first candidate, as many as keep the events (nev[b], the
    bundle's valid windows) within DIGI_GROUP_ITEMS // ntables, and at
    least one. A bundle with more events than that is a group alone."""
    cap = DIGI_GROUP_ITEMS // ntables
    groups = []
    i = 0
    while i < len(cand):
        tile = cand[i] // DIGI_SCAN_THREADS
        total, j = nev[cand[i]], i + 1
        if total <= cap:
            while (j < len(cand) and cand[j] // DIGI_SCAN_THREADS == tile
                   and total + nev[cand[j]] <= cap):
                total += nev[cand[j]]
                j += 1
        groups.append(cand[i:j])
        i = j
    return groups


def diginorm_plan(L, k, ntables):
    """Kernel F's scratch for a window of rows of L codes, k-mers of k and
    `ntables` tables: {"sub": events a sub-chunk of a lone bundle's adds,
    "group_events": the most events a group holds, DIGI_GROUP_ITEMS //
    ntables (a bundle with more runs alone), "smem": dynamic shared bytes,
    "group", "alone", "tile": {name: shared bytes}, "union": bytes of
    the union of "group" and "alone", "hash_words": words of the device
    buffer that holds a lone bundle's hashes, 0 when they are in shared
    memory}.

    The shared memory is the union of two layouts, rounded up to 16
    bytes, then the tile's candidate list, in the kernel's order:
    - "group", the overlay: claims (4 B a slot: the item that took it),
      the counter of each (event, table) item (8 B an item), hits and
      lowest events (4 B a slot each), values and dirty bits (2 B a
      slot), each item's slot with its owner bit (2 B an item), new
      flags (1 B an event);
    - "alone", a lone bundle's map: keys (8 B a slot), its hashes (8 B
      for each of its at most 2 (L - k + 1) windows) unless they do not
      fit DIGI_SMEM_LIMIT (rows of about 10,000 codes and more), hits and
      lowest events (4 B a slot each), a sub-chunk's new flags (1 B an
      event);
    - "tile": per candidate its two reads' window counts (8 B), its
      bundle (4 B), and where its events start (4 B, one more).
    It follows the window (L, k) and the number of tables, never their
    size: there is no other scratch."""
    L, k, ntables = int(L), int(k), int(ntables)
    if not 1 <= k <= 32 or L < k:
        raise ValueError("rows of %d codes hold no %d-mer" % (L, k))
    if not 1 <= ntables <= MAX_TABLES:
        raise ValueError("the byte kernels take 1 to %d tables, not %d"
                         % (MAX_TABLES, ntables))
    S, G, M = DIGI_OVERLAY_SLOTS, DIGI_GROUP_ITEMS, DIGI_MAP_SLOTS
    sub = M // (2 * ntables)
    gev = G // ntables
    words = 2 * (L - k + 1)
    group = {"claim": 4 * S, "keys": 8 * G, "hits": 4 * S, "first": 4 * S,
             "values": 2 * S, "slots": 2 * G, "fresh": gev}
    alone = {"keys": 8 * M, "hashes": 8 * words, "hits": 4 * M,
             "first": 4 * M, "fresh": sub}
    T = DIGI_SCAN_THREADS
    tile = {"reads": 8 * T, "list": 4 * T, "starts": 4 * (T + 1)}

    def union():
        return -(-max(sum(group.values()), sum(alone.values())) // 16) * 16

    hash_words = 0
    if union() + sum(tile.values()) > DIGI_SMEM_LIMIT:
        del alone["hashes"]
        hash_words = words
    return {"sub": sub, "group_events": gev,
            "smem": union() + sum(tile.values()), "group": group,
            "alone": alone, "tile": tile, "union": union(),
            "hash_words": hash_words}


def _check_rows(codes, lengths, k, dev):
    if codes.device != dev or lengths.device != dev:
        raise ValueError("codes and lengths must be on %s" % dev)
    if (codes.dtype != torch.uint8 or codes.dim() != 2
            or not codes.is_contiguous()):
        raise ValueError("codes must be a contiguous uint8 [R, L] tensor")
    if (lengths.dtype != torch.int32 or lengths.dim() != 1
            or not lengths.is_contiguous()
            or lengths.shape[0] != codes.shape[0]):
        raise ValueError("lengths must be a contiguous int32 [R] tensor")
    if not 1 <= int(k) <= 32 or codes.shape[1] < int(k):
        raise ValueError("rows of %d codes hold no %d-mer"
                         % (codes.shape[1], k))


def _check_window(codes, lengths, k, dev):
    """_check_rows for a window of bundles: two rows a bundle."""
    _check_rows(codes, lengths, k, dev)
    if codes.shape[0] % 2:
        raise ValueError("a window holds two rows a bundle, not %d rows"
                         % codes.shape[0])


def _bundle_flags(t, B, dev, what):
    if (t.device != dev or t.dtype != torch.bool or t.dim() != 1
            or t.shape[0] != B or not t.is_contiguous()):
        raise ValueError("%s must be a contiguous bool [%d] tensor on %s"
                         % (what, B, dev))


def _cutoff_arg(cutoff, top=MAX_KCOUNT):
    """A count threshold as the kernels take it: an int32; any above `top`,
    the largest count they read (255 for the u8 tables, MAX_BIGCOUNT with
    the bigcount map), is one that no count meets."""
    return max(min(int(cutoff), top + 1), -1)


def _check_counter(t, dev, name):
    if (t.device != dev or t.dtype != torch.int64 or t.numel() != 1
            or not t.is_contiguous()):
        raise ValueError("%s must be an int64 [1] tensor on %s" % (name, dev))


def diginorm_med_cuda(primes, k, cutoff, flat, codes, lengths, loads=None):
    """Kernel E (csrc/diginorm_med.cu): med_ok_plain on the card -> bool
    [B], tiled by med_plan; the counter loads it issued (med_load_plan's)
    are added to `loads` (int64 [1] on the card) when given. Counts its
    launches in ``diginorm_med_cuda.launches``."""
    dev = flat.device
    _check_byte_layout(primes, flat)
    _check_window(codes, lengths, k, dev)
    if loads is not None:
        _check_counter(loads, dev, "loads")
    B = codes.shape[0] // 2
    reject = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return reject
    plan = med_plan(codes.shape[1], k)
    primes_arr, offsets_arr = _layout(primes)
    err = cuda.library().khmer_diginorm_med(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), codes.data_ptr(), lengths.data_ptr(),
        B, codes.shape[1], int(k), _cutoff_arg(cutoff), plan["rows"],
        plan["seg"], plan["bit_words"], reject.data_ptr(), _ptr(loads),
        dev.index, _stream(dev))
    cuda.check(err, "diginorm_med")
    diginorm_med_cuda.launches += 1
    return reject


diginorm_med_cuda.launches = 0


def diginorm_med(primes, k, cutoff, flat, codes, lengths, loads=None):
    """Phase A's rejections, bool [B], the counter loads of kernel E's rule
    added to `loads` when given: kernel E on a CUDA buffer, its plain
    mirror (med_load_plan) on a CPU one."""
    if flat.is_cuda:
        return diginorm_med_cuda(primes, k, cutoff, flat, codes, lengths,
                                 loads)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    reject, loaded = med_load_plan(primes, k, cutoff, flat, codes, lengths)
    if loads is not None:
        loads += loaded.sum()
    return reject


def diginorm_scan_cuda(primes, k, cutoff, flat, n_unique, codes, lengths,
                       reject, n_cand=None, n_groups=None):
    """Kernel F (csrc/diginorm_scan.cu): diginorm_window_plain with kernel
    E's `reject` on the card, one launch for the window, the u8 tables
    updated in place; its only scratch is diginorm_plan's, sized by the
    row length and the number of tables.
    Returns keep, bool [B]; the bundles it tested are added to `n_cand`
    and the groups it formed of them to `n_groups` (each int64 [1] on the
    card) when given. Counts its launches in
    ``diginorm_scan_cuda.launches``."""
    dev = flat.device
    _check_byte_layout(primes, flat)
    _check_window(codes, lengths, k, dev)
    B = codes.shape[0] // 2
    _bundle_flags(reject, B, dev, "reject")
    if n_cand is None:
        n_cand = torch.zeros(1, dtype=torch.int64, device=dev)
    for name, t in (("n_unique", n_unique), ("n_cand", n_cand),
                    ("n_groups", n_groups)):
        if t is not None or name != "n_groups":
            _check_counter(t, dev, name)
    keep = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return keep
    plan = diginorm_plan(codes.shape[1], k, len(primes))
    hashes = None
    if plan["hash_words"]:
        hashes = torch.empty(plan["hash_words"], dtype=torch.int64,
                             device=dev)
    primes_arr, offsets_arr = _layout(primes)
    err = cuda.library().khmer_diginorm_scan(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), codes.data_ptr(), lengths.data_ptr(),
        reject.data_ptr(), B, codes.shape[1], int(k), _cutoff_arg(cutoff),
        plan["sub"], plan["smem"],
        None if hashes is None else hashes.data_ptr(), keep.data_ptr(),
        n_unique.data_ptr(), n_cand.data_ptr(), _ptr(n_groups), dev.index,
        _stream(dev))
    cuda.check(err, "diginorm_scan")
    diginorm_scan_cuda.launches += 1
    return keep


diginorm_scan_cuda.launches = 0


def diginorm_scan(primes, k, cutoff, flat, n_unique, codes, lengths, reject,
                  n_cand=None, n_groups=None):
    """The keep/consume scan of one window over the bundles phase A did not
    reject, in place -> keep, bool [B], the bundles it tested added to
    `n_cand` and kernel F's groups of them to `n_groups` when given:
    kernel F on a CUDA buffer, the plain version on a CPU one."""
    if flat.is_cuda:
        return diginorm_scan_cuda(primes, k, cutoff, flat, n_unique, codes,
                                  lengths, reject, n_cand, n_groups)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return diginorm_window_plain(primes, k, cutoff, flat, n_unique, codes,
                                 lengths, reject, n_cand, n_groups)


# --------------------------------------------------------------------------
# trim-low-abund: the pass-1 scan (kernel G) and the read-only per-read count
# and trim (kernel H)
# --------------------------------------------------------------------------


def _trim_pos(nvalid, bad0, first_bad, k):
    """The trim position of JAX make_trim1_window (hashtable.cc:504-533) of
    a read with `nvalid` windows, whether window 0 is below the cutoff and
    the first later window that is (None: none): 0 for a read whose window
    0 is bad or that has one window, k + j - 1 for a first bad window j >=
    1, else its length, nvalid + k - 1 (k - 1 for an absent read)."""
    if (nvalid and bad0) or nvalid == 1:
        return 0
    if first_bad is not None:
        return k + first_bad - 1
    return nvalid + k - 1


def trim_window_plain(primes, k, cutoff, trim_cov, digi_cov, flat, n_unique,
                      codes, lengths):
    """trim-low-abund's pass-1 scan of one window, in stream order (JAX
    diginorm_scan.make_trim1_window with _step_gather, _med_at_least and
    _consume_bundle; plain PyTorch, any device, a Python loop over
    bundles). Updates the u8 tables in `flat` and n_unique (int64 [1]) in
    place and returns (branch int32 [B], trim_at int32 [B, 2]).

    Per bundle, from the min-over-tables counts under the tables the
    earlier bundles left: branch 0 with `digi_cov` (not None) if every
    present read has median_at_least(digi_cov) (drop), else 1 if every
    present read has median_at_least(trim_cov) (emit trimmed), else 2
    (consume: +1 to the counter of each valid window in each table,
    saturating at 255, n_unique by _consume_bundle's rule). An absent read
    passes both tests. trim_at is each read's _trim_pos under `cutoff`, at
    the bundle's position in the stream, whatever its branch. The bigcount
    map plays no part, as in the JAX scan."""
    hashes, valid, nvalid = _window_hashes(codes, lengths, k)
    dev = codes.device
    B = codes.shape[0] // 2
    nw = valid.sum(dim=1).tolist()
    nv = nvalid.tolist()
    min_req = _min_required(nvalid).tolist()
    offsets = byte_offsets(primes)
    thresholds = [int(trim_cov)] + ([] if digi_cov is None
                                    else [int(digi_cov)])
    cut = int(cutoff)
    branch = [0] * B
    trim_at = [[0, 0] for _ in range(B)]
    for b in range(B):
        if b % _PLAIN_BLOCK == 0:
            # every window's counter in each table, for the next block of
            # bundles (they depend on the hashes alone)
            rows = slice(2 * b, 2 * (b + _PLAIN_BLOCK))
            block = torch.stack([umod(hashes[rows], p) + o
                                 for p, o in zip(primes, offsets)])
        r0 = 2 * b
        j = r0 - 2 * (b - b % _PLAIN_BLOCK)
        n0, n1 = nw[r0], nw[r0 + 1]
        # _step_gather: the bundle's events, their counters and counts
        counters = torch.cat([block[:, j, :n0], block[:, j + 1, :n1]],
                             dim=1)
        old = flat[counters]
        counts = old.amin(dim=0).to(torch.int32)
        stats = []
        for c in (counts[:n0], counts[n0:]):
            stats += [(c >= x).sum() for x in thresholds]
            # window 0 below the cutoff; the first later one, or len(c)
            # (two sentinels: an absent read's c is empty)
            bad = torch.cat([c < cut, torch.ones(2, dtype=torch.bool,
                                                 device=dev)])
            stats += [bad[0].long(), bad[1:].to(torch.uint8).argmax() + 1]
        stats = torch.stack(stats).tolist()
        per = len(thresholds) + 2
        ok = [[not nv[r0 + r] or stats[r * per + i] >= min_req[r0 + r]
               for r in (0, 1)] for i in range(len(thresholds))]
        if digi_cov is not None and all(ok[1]):
            branch[b] = 0
        elif all(ok[0]):
            branch[b] = 1
        else:
            branch[b] = 2
        for r, n in enumerate((n0, n1)):
            first = stats[r * per + per - 1]
            trim_at[b][r] = _trim_pos(nv[r0 + r], stats[r * per + per - 2],
                                      first if first < n else None, k)
        if branch[b] == 2:
            _consume_bundle(flat, n_unique, counters, old)
    return (torch.tensor(branch, dtype=torch.int32, device=dev),
            torch.tensor(trim_at, dtype=torch.int32,
                         device=dev).reshape(B, 2))


# Kernel G: a pre-pass (csrc/trim_prepass.cu; blocks of TRIM_PRE_THREADS
# threads, a warp a bundle) gives every bundle of a window a state from the
# tables as the window starts: TRIM_LIVE for a candidate (a bundle that
# would take branch 2 now), TRIM_PROBE or TRIM_PROBE_DIGI for a bundle with
# windows that a candidate's adds might move across cutoff (or digi_cov),
# TRIM_SETTLED for the rest, whose branch and trim positions are final. The
# probe then turns each PROBE bundle LIVE or SETTLED. The walk
# (csrc/trim_scan.cu) runs the LIVE bundles in stream order, in kernel F's
# tiles and groups (TRIM_THREADS, TRIM_OVERLAY_SLOTS, TRIM_GROUP_ITEMS: F's
# constants), a bundle too large for a group through a map of
# TRIM_MAP_SLOTS counters. These mirror the kernels' constants.
TRIM_SETTLED, TRIM_LIVE, TRIM_PROBE, TRIM_PROBE_DIGI = 0, 1, 2, 3
TRIM_PRE_THREADS = 256
TRIM_MARK_BITS = (16, 27)  # the pre-pass's set: 2^16 to 2^27 bits
TRIM_THREADS = DIGI_SCAN_THREADS
TRIM_OVERLAY_SLOTS = DIGI_OVERLAY_SLOTS
TRIM_GROUP_ITEMS = DIGI_GROUP_ITEMS
TRIM_MAP_SLOTS = 4096
TRIM_SMEM_LIMIT = DIGI_SMEM_LIMIT
_FIB = to_signed(0x9E3779B97F4A7C15)  # 2^64 / golden ratio


def trim_plan(ntables, nbundles=0, W=0):
    """Kernel G's scratch for `ntables` tables and a window of `nbundles`
    bundles of rows of W windows (L - k + 1): {"sub": events a sub-chunk of
    a lone bundle's adds, "group_events": the most events a group holds,
    TRIM_GROUP_ITEMS // ntables, "smem": the walk's dynamic shared bytes,
    "group", "alone", "tile": {name: shared bytes}, "union": bytes of the
    union of "group" and "alone", "mark_bits": log2 of the bits of the
    pre-pass's set, "mark_words": its 32-bit words}.

    The walk's shared memory is the union of two layouts, rounded up to 16
    bytes, then the tile's list, in the kernel's order:
    - "group", kernel F's overlay (diginorm_plan);
    - "alone", a lone bundle's map: keys (8 B a slot), hits and lowest
      events (4 B a slot each), each sub-chunk item's slot (2 B,
      TRIM_MAP_SLOTS // 2 items), a sub-chunk's new flags (1 B an event);
    - "tile": per live bundle its two reads' window counts (8 B), its
      bundle (4 B), and where its events start (4 B, one more).
    It follows the number of tables alone. The set follows the window: at
    least 4 bits for each counter its candidates could mark (2 nbundles W
    ntables), within TRIM_MARK_BITS; never the tables' size."""
    ntables = int(ntables)
    if not 1 <= ntables <= MAX_TABLES:
        raise ValueError("the byte kernels take 1 to %d tables, not %d"
                         % (MAX_TABLES, ntables))
    S, G, M = TRIM_OVERLAY_SLOTS, TRIM_GROUP_ITEMS, TRIM_MAP_SLOTS
    sub = M // (2 * ntables)
    gev = G // ntables
    group = {"claim": 4 * S, "keys": 8 * G, "hits": 4 * S, "first": 4 * S,
             "values": 2 * S, "slots": 2 * G, "fresh": gev}
    alone = {"keys": 8 * M, "hits": 4 * M, "first": 4 * M,
             "slots": 2 * (M // 2), "fresh": sub}
    T = TRIM_THREADS
    tile = {"reads": 8 * T, "list": 4 * T, "starts": 4 * (T + 1)}
    union = -(-max(sum(group.values()), sum(alone.values())) // 16) * 16
    marks = 8 * int(nbundles) * max(int(W), 0) * ntables
    lo, hi = TRIM_MARK_BITS
    bits = min(max(max(marks - 1, 1).bit_length(), lo), hi)
    return {"sub": sub, "group_events": gev,
            "smem": union + sum(tile.values()), "group": group,
            "alone": alone, "tile": tile, "union": union,
            "mark_bits": bits, "mark_words": (1 << bits) // 32}


def _trim_counters(primes, k, flat, codes, lengths):
    """(counters int64 [T, 2B, W], their values int32, valid bool [2B, W],
    nvalid [2B]) of a window's reads: each window's flat counter in each
    table, as _window_hashes takes the windows."""
    hashes, valid, nvalid = _window_hashes(codes, lengths, k)
    counters = torch.stack([umod(hashes, p) + o
                            for p, o in zip(primes, byte_offsets(primes))])
    return counters, flat[counters].to(torch.int32), valid, nvalid


def _mark_bit(counters, bits):
    """The pre-pass's set bit of flat counters: the top `bits` bits of the
    u64 product counter * 2^64 / golden ratio (csrc/trim_prepass.cu
    mark_bit)."""
    return srl(counters * _FIB, 64 - bits)


def _marks_log2(marks):
    """log2 of the bits of the set held in `marks` (int32 words)."""
    return (marks.numel() * 32).bit_length() - 1


def trim_mark_plain(primes, k, cutoff, trim_cov, digi_cov, flat, codes,
                    lengths, marks, n_cand=None):
    """The pre-pass's mark step (csrc/trim_prepass.cu mark_kernel; plain
    PyTorch, any device): every bundle of the window against the tables as
    they stand, read only -> (state uint8 [B], branch int32 [B], trim_at
    int32 [B, 2]), trim_window_plain's branch and trim positions for a
    bundle that came first. A bundle of branch 2 is a candidate, state
    TRIM_LIVE: the bit (_mark_bit) of every counter of every valid window
    of it, in every table, is set in `marks` (int32 words, a power of two
    of them, in place); the candidates are added to `n_cand` when given.
    Any other bundle is TRIM_PROBE_DIGI if --diginorm's test fails it (it
    passes trim_cov), else TRIM_PROBE if some window of it is below
    `cutoff`, else TRIM_SETTLED."""
    counters, vals, valid, nvalid = _trim_counters(primes, k, flat, codes,
                                                   lengths)
    counts = vals.amin(dim=0)
    B = codes.shape[0] // 2
    need = _min_required(nvalid)
    absent = nvalid == 0

    def passes(x):
        ge = (valid & (counts >= int(x))).sum(dim=1)
        return ((ge >= need) | absent).reshape(B, 2).all(dim=1)

    ok_trim = passes(trim_cov)
    ok_digi = (passes(digi_cov) if digi_cov is not None
               else torch.zeros_like(ok_trim))
    branch = torch.where(ok_digi, 0, torch.where(ok_trim, 1, 2))
    bad = valid & (counts < int(cutoff))
    W = counts.shape[1]
    pos = torch.arange(W, device=codes.device)
    first = torch.where(bad & (pos >= 1), pos, W).amin(dim=1)
    trim_at = torch.where(first < W, k + first - 1, nvalid + k - 1)
    trim_at = torch.where(bad[:, 0] | (nvalid == 1), 0, trim_at)
    cand = branch == 2
    state = torch.where(
        cand, TRIM_LIVE, torch.where(
            ~ok_digi & (digi_cov is not None), TRIM_PROBE_DIGI,
            torch.where(bad.reshape(B, -1).any(dim=1), TRIM_PROBE,
                        TRIM_SETTLED)))
    chosen = valid & cand.repeat_interleave(2)[:, None]
    bit = torch.unique(_mark_bit(counters[:, chosen], _marks_log2(marks)))
    words = torch.zeros(marks.shape, dtype=torch.int64, device=marks.device)
    words.index_add_(0, bit >> 5, torch.ones_like(bit) << (bit & 31))
    marks |= torch.where(words > _I32_MAX, words - (1 << 32),
                         words).to(torch.int32)
    if n_cand is not None:
        n_cand += cand.sum()
    return (state.to(torch.uint8), branch.to(torch.int32),
            trim_at.reshape(B, 2).to(torch.int32))


def trim_probe_plain(primes, k, cutoff, digi_cov, flat, codes, lengths,
                     marks, state):
    """The pre-pass's probe step (csrc/trim_prepass.cu probe_kernel; plain
    PyTorch, any device), in place on `state` (uint8 [B]), which it
    returns: a TRIM_PROBE or TRIM_PROBE_DIGI bundle becomes TRIM_LIVE iff
    some valid window of it has a count below a threshold that matters to
    it (cutoff; digi_cov too for TRIM_PROBE_DIGI) and every counter of that
    window below the threshold has its bit set in `marks`; else
    TRIM_SETTLED."""
    counters, vals, valid, _ = _trim_counters(primes, k, flat, codes,
                                              lengths)
    bit = _mark_bit(counters, _marks_log2(marks))
    marked = ((marks[bit >> 5].to(torch.int64) >> (bit & 31)) & 1).bool()

    def movable(x):
        low = vals < int(x)
        return valid & low.any(dim=0) & (~low | marked).all(dim=0)

    hit = movable(cutoff)
    if digi_cov is not None:
        rows = (state == TRIM_PROBE_DIGI).repeat_interleave(2)
        hit |= movable(digi_cov) & rows[:, None]
    live = hit.reshape(state.shape[0], -1).any(dim=1)
    probe = (state == TRIM_PROBE) | (state == TRIM_PROBE_DIGI)
    state[probe & live] = TRIM_LIVE
    state[probe & ~live] = TRIM_SETTLED
    return state


def trim_classify_plain(primes, k, cutoff, trim_cov, digi_cov, flat, codes,
                        lengths, marks=None):
    """Kernel G's pre-pass, mark then probe (plain PyTorch, any device),
    read only: (candidates bool [B], live bool [B], branch int32 [B],
    trim_at int32 [B, 2]), the outputs final for the bundles not live.
    `marks`, the set (int32 words), defaults to an empty one of trim_plan's
    size; a set with bits set beforehand errs towards live, as a shared
    bit does."""
    B, W = codes.shape[0] // 2, codes.shape[1] - k + 1
    if marks is None:
        marks = torch.zeros(trim_plan(len(primes), B, W)["mark_words"],
                            dtype=torch.int32, device=codes.device)
    state, branch, trim_at = trim_mark_plain(
        primes, k, cutoff, trim_cov, digi_cov, flat, codes, lengths, marks)
    cand = state == TRIM_LIVE
    trim_probe_plain(primes, k, cutoff, digi_cov, flat, codes, lengths,
                     marks, state)
    return cand, state == TRIM_LIVE, branch, trim_at


def trim_walk_plain(primes, k, cutoff, trim_cov, digi_cov, flat, n_unique,
                    codes, lengths, state, branch, trim_at, n_live=None,
                    n_groups=None):
    """Kernel G's walk (plain PyTorch, any device): trim_window_plain over
    the bundles whose `state` is TRIM_LIVE alone, in stream order, their
    branch and trim_at written in place (the others keep theirs), the
    tables and n_unique updated in place. The live bundles are added to
    `n_live` and the groups the kernel forms of them (scan_groups) to
    `n_groups` when given. Returns (branch, trim_at)."""
    live = torch.nonzero(state == TRIM_LIVE).flatten()
    rows = torch.stack([2 * live, 2 * live + 1], dim=1).flatten()
    b, t = trim_window_plain(primes, k, cutoff, trim_cov, digi_cov, flat,
                             n_unique, codes[rows], lengths[rows])
    branch[live] = b
    trim_at[live] = t
    if n_live is not None:
        n_live += live.numel()
    if n_groups is not None:
        W = codes.shape[1] - k + 1
        nw = torch.clamp(lengths.to(torch.int64) - (k - 1), 0, W)
        nev = (nw[0::2] + nw[1::2]).tolist()
        n_groups += len(scan_groups(nev, live.tolist(), len(primes)))
    return branch, trim_at


def _trim_args(primes, k, flat, codes, lengths):
    dev = flat.device
    _check_byte_layout(primes, flat)
    _check_window(codes, lengths, k, dev)
    return dev, codes.shape[0] // 2


def _check_marks(marks, dev):
    n = marks.numel()
    if (marks.device != dev or marks.dtype != torch.int32 or marks.dim() != 1
            or not marks.is_contiguous() or n < 1 or n & (n - 1)):
        raise ValueError("marks must be a contiguous int32 tensor of a "
                         "power of two words on %s" % dev)


def _check_state(state, B, dev):
    if (state.device != dev or state.dtype != torch.uint8
            or state.shape != (B,) or not state.is_contiguous()):
        raise ValueError("state must be a contiguous uint8 [%d] tensor on "
                         "%s" % (B, dev))


def trim_mark_cuda(primes, k, cutoff, trim_cov, digi_cov, flat, codes,
                   lengths, marks, n_cand=None):
    """The pre-pass's mark launch (csrc/trim_prepass.cu): trim_mark_plain
    on the card -> (state, branch, trim_at); `marks` is cleared first.
    Counts its launches in ``trim_mark_cuda.launches``."""
    dev, B = _trim_args(primes, k, flat, codes, lengths)
    _check_marks(marks, dev)
    if n_cand is not None:
        _check_counter(n_cand, dev, "n_cand")
    state = torch.empty(B, dtype=torch.uint8, device=dev)
    branch = torch.empty(B, dtype=torch.int32, device=dev)
    trim_at = torch.empty((B, 2), dtype=torch.int32, device=dev)
    if B == 0:
        return state, branch, trim_at
    primes_arr, offsets_arr = _layout(primes)
    err = cuda.library().khmer_trim_mark(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), codes.data_ptr(), lengths.data_ptr(),
        B, codes.shape[1], int(k), _cutoff_arg(cutoff),
        _cutoff_arg(trim_cov), _cutoff_arg(0 if digi_cov is None
                                          else digi_cov),
        int(digi_cov is not None), _marks_log2(marks), marks.data_ptr(),
        state.data_ptr(), branch.data_ptr(), trim_at.data_ptr(),
        _ptr(n_cand), dev.index, _stream(dev))
    cuda.check(err, "trim_mark")
    trim_mark_cuda.launches += 1
    return state, branch, trim_at


trim_mark_cuda.launches = 0


def trim_probe_cuda(primes, k, cutoff, digi_cov, flat, codes, lengths,
                    marks, state):
    """The pre-pass's probe launch (csrc/trim_prepass.cu): trim_probe_plain
    on the card, in place on `state`, which it returns. Counts its launches
    in ``trim_probe_cuda.launches``."""
    dev, B = _trim_args(primes, k, flat, codes, lengths)
    _check_marks(marks, dev)
    _check_state(state, B, dev)
    if B == 0:
        return state
    primes_arr, offsets_arr = _layout(primes)
    err = cuda.library().khmer_trim_probe(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), codes.data_ptr(), lengths.data_ptr(),
        B, codes.shape[1], int(k), _cutoff_arg(cutoff),
        _cutoff_arg(-1 if digi_cov is None else digi_cov), _marks_log2(marks),
        marks.data_ptr(), state.data_ptr(), dev.index, _stream(dev))
    cuda.check(err, "trim_probe")
    trim_probe_cuda.launches += 1
    return state


trim_probe_cuda.launches = 0


def trim_walk_cuda(primes, k, cutoff, trim_cov, digi_cov, flat, n_unique,
                   codes, lengths, state, branch, trim_at, n_live=None,
                   n_groups=None):
    """Kernel G's walk (csrc/trim_scan.cu): trim_walk_plain on the card,
    one launch, the u8 tables updated in place; its only scratch is
    trim_plan's shared memory. Returns (branch, trim_at). Counts its
    launches in ``trim_walk_cuda.launches``."""
    dev, B = _trim_args(primes, k, flat, codes, lengths)
    _check_state(state, B, dev)
    for name, t in (("n_unique", n_unique), ("n_live", n_live),
                    ("n_groups", n_groups)):
        if t is not None or name == "n_unique":
            _check_counter(t, dev, name)
    if (branch.shape != (B,) or trim_at.shape != (B, 2)
            or branch.dtype != torch.int32 or trim_at.dtype != torch.int32
            or branch.device != dev or trim_at.device != dev
            or not branch.is_contiguous() or not trim_at.is_contiguous()):
        raise ValueError("branch and trim_at must be contiguous int32 [%d] "
                         "and [%d, 2] tensors on %s" % (B, B, dev))
    if B == 0:
        return branch, trim_at
    plan = trim_plan(len(primes))
    primes_arr, offsets_arr = _layout(primes)
    err = cuda.library().khmer_trim_scan(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), codes.data_ptr(), lengths.data_ptr(),
        state.data_ptr(), B, codes.shape[1], int(k), _cutoff_arg(cutoff),
        _cutoff_arg(trim_cov), _cutoff_arg(0 if digi_cov is None
                                          else digi_cov),
        int(digi_cov is not None), plan["sub"], plan["smem"],
        branch.data_ptr(), trim_at.data_ptr(), n_unique.data_ptr(),
        _ptr(n_live), _ptr(n_groups), dev.index, _stream(dev))
    cuda.check(err, "trim_scan")
    trim_walk_cuda.launches += 1
    return branch, trim_at


trim_walk_cuda.launches = 0


def trim_scan_cuda(primes, k, cutoff, trim_cov, digi_cov, flat, n_unique,
                   codes, lengths, n_cand=None, n_live=None, n_groups=None):
    """Kernel G on the card, trim_window_plain's answer: the mark, probe
    and walk launches on the current stream, no host synchronisation; the
    only scratch beside the walk's shared memory is the pre-pass's set and
    a state byte a bundle (trim_plan, sized by the window). Returns
    (branch int32 [B], trim_at int32 [B, 2]); the candidates, live bundles
    and groups are added to the counters given."""
    dev, B = _trim_args(primes, k, flat, codes, lengths)
    plan = trim_plan(len(primes), B, codes.shape[1] - k + 1)
    marks = torch.empty(plan["mark_words"], dtype=torch.int32, device=dev)
    state, branch, trim_at = trim_mark_cuda(primes, k, cutoff, trim_cov,
                                            digi_cov, flat, codes, lengths,
                                            marks, n_cand)
    trim_probe_cuda(primes, k, cutoff, digi_cov, flat, codes, lengths, marks,
                    state)
    return trim_walk_cuda(primes, k, cutoff, trim_cov, digi_cov, flat,
                          n_unique, codes, lengths, state, branch, trim_at,
                          n_live, n_groups)


def trim_scan(primes, k, cutoff, trim_cov, digi_cov, flat, n_unique, codes,
              lengths, n_cand=None, n_live=None, n_groups=None):
    """trim-low-abund's pass-1 scan of one window, in place -> (branch,
    trim_at), trim_window_plain's answer; the candidates, live bundles and
    the walk's groups added to the counters given: kernel G (pre-pass and
    walk) on a CUDA buffer, their plain versions on a CPU one."""
    if flat.is_cuda:
        return trim_scan_cuda(primes, k, cutoff, trim_cov, digi_cov, flat,
                              n_unique, codes, lengths, n_cand, n_live,
                              n_groups)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    B, W = codes.shape[0] // 2, codes.shape[1] - k + 1
    marks = torch.zeros(trim_plan(len(primes), B, W)["mark_words"],
                        dtype=torch.int32)
    state, branch, trim_at = trim_mark_plain(primes, k, cutoff, trim_cov,
                                             digi_cov, flat, codes, lengths,
                                             marks, n_cand)
    trim_probe_plain(primes, k, cutoff, digi_cov, flat, codes, lengths,
                     marks, state)
    return trim_walk_plain(primes, k, cutoff, trim_cov, digi_cov, flat,
                           n_unique, codes, lengths, state, branch, trim_at,
                           n_live, n_groups)


def bigcount_table(bigcounts, device):
    """A sketch's bigcount map as kernel H takes it: (keys int64 [n], the
    u64 hashes' bits in ascending unsigned order; values int32 [n]) on
    `device`."""
    keys = np.fromiter(bigcounts.keys(), dtype=np.uint64,
                       count=len(bigcounts))
    values = np.fromiter(bigcounts.values(), dtype=np.int32,
                         count=len(bigcounts))
    order = np.argsort(keys, kind="stable")
    return (torch.from_numpy(keys[order].view(np.int64).copy()).to(device),
            torch.from_numpy(values[order].copy()).to(device))


def _big_arg(big, dev):
    if big is None:
        return None
    keys, values = big
    if (keys.device != dev or values.device != dev
            or keys.dtype != torch.int64 or values.dtype != torch.int32
            or keys.dim() != 1 or keys.shape != values.shape
            or not keys.is_contiguous() or not values.is_contiguous()):
        raise ValueError("big must be bigcount_table's (int64 [n], int32 "
                         "[n]) on %s" % dev)
    return big if keys.shape[0] else None


def byte_counts_plain(primes, flat, hashes, big=None, valid=None):
    """byte_gather_plain's counts of `hashes` (any shape), a count of 255
    read through `big` (bigcount_table) where the map has its hash (only
    where `valid`, where given) -> int32."""
    counts = byte_gather_plain(primes, flat, hashes)
    big = _big_arg(big, flat.device)
    if big is not None:
        keys, values = big
        sat = counts == MAX_KCOUNT
        if valid is not None:
            sat &= valid
        h = hashes[sat]
        pos = torch.searchsorted(keys ^ _SIGN, h ^ _SIGN).clamp_(
            max=keys.shape[0] - 1)
        counts[sat] = torch.where(keys[pos] == h, values[pos],
                                  torch.full_like(values[pos], MAX_KCOUNT))
    return counts


def _read_window_counts(primes, k, flat, codes, lengths, big):
    """(counts [R, W], valid [R, W], nvalid [R]) of kernel H's rows: the
    minimum over the tables of each window's counter, a count of 255 read
    through `big` (bigcount_table) where the map has its hash."""
    hashes, valid, nvalid = _window_hashes(codes, lengths, k)
    return byte_counts_plain(primes, flat, hashes, big, valid), valid, nvalid


def read_counts_plain(primes, k, cutoff, at_least, flat, codes, lengths,
                      big=None):
    """Per read of codes [R, L] / lengths [R], from the minimum over the
    tables of each window's counter (read only; plain PyTorch, any device):
    (trim_at int32 [R], n_ge int32 [R]). trim_at is trim_pos_from_counts
    (utils/trimming.py) under `cutoff`: 0 for a read with no window or one,
    or whose window 0 is below it; k + j - 1 for the first later window j
    below it; else the read's length. n_ge counts the windows at or above
    `at_least`, which median_at_least needs. With `big` (bigcount_table), a
    count of 255 is the map's value for its hash where the map has one, as
    JAX pipeline.counts_for_records reads it."""
    counts, valid, nvalid = _read_window_counts(primes, k, flat, codes,
                                                lengths, big)
    n_ge = (valid & (counts >= int(at_least))).sum(dim=1)
    bad = valid & (counts < int(cutoff))
    W = bad.shape[1]
    j = torch.arange(W, device=codes.device)
    first = torch.where(bad & (j >= 1), j, W).amin(dim=1)
    trim = torch.where(first < W, k + first - 1, lengths.to(torch.int64))
    trim = torch.where(bad[:, 0] | (nvalid <= 1), 0, trim)
    return trim.to(torch.int32), n_ge.to(torch.int32)


# Kernel H (csrc/read_counts.cu): blocks of READ_THREADS threads, each
# taking the items of one segment (at most READ_SEG windows) of a tile of
# rows (at most READ_MAX_ROWS), about READ_ITEMS items a block; these
# mirror its constants. READ_SMEM_LIMIT is the dynamic shared memory it
# asks for at most (a block's 227 KB on the H100, less 2 KB for its static
# shared words).
READ_THREADS = 256
READ_MAX_ROWS = 64
READ_SEG = 1024
READ_ITEMS = 512
READ_SMEM_LIMIT = 227 * 1024 - 2048


@functools.lru_cache(maxsize=64)
def read_plan(L, k):
    """Kernel H's tiling for rows of L codes and k-mers of k: {"rows": rows
    a tile, "seg": windows a segment (a multiple of 32), "segs": segments
    a row, "smem": dynamic shared bytes}. A block takes one segment of one
    tile: rows of up to READ_SEG windows are one segment (one block holds
    whole rows and writes their outputs), longer ones are cut into segments
    of READ_SEG over as many blocks. Per row the block keeps the segment's
    packed codes, forward and reverse (16 B for each 32 codes of its seg +
    31, rounded up to words), and the row of each of its items (1 B an
    item). It follows the shape (L, k), never the tables."""
    L, k = int(L), int(k)
    if not 1 <= k <= 32 or L < k:
        raise ValueError("rows of %d codes hold no %d-mer" % (L, k))
    W = L - k + 1
    seg = min(-(-W // 32) * 32, READ_SEG)
    per_row = 16 * (seg // 32 + 1) + seg
    rows = max(1, min(READ_MAX_ROWS, READ_ITEMS // seg,
                      READ_SMEM_LIMIT // per_row))
    return {"rows": rows, "seg": seg, "segs": -(-W // seg),
            "smem": rows * per_row}


def read_blocks(R, L, k):
    """Kernel H's blocks over R rows of L codes, in grid order: (first row,
    row past the last, first window, window past the last) of each, the
    windows cut at the rows' L - k + 1 (a read's own windows may end
    sooner)."""
    plan = read_plan(L, k)
    rows, seg, W = plan["rows"], plan["seg"], int(L) - int(k) + 1
    for row0 in range(0, R, rows):
        for s0 in range(0, W, seg):
            yield row0, min(row0 + rows, R), s0, min(s0 + seg, W)


def read_split_plain(primes, k, cutoff, at_least, flat, codes, lengths,
                     big=None):
    """read_counts_plain as kernel H splits and combines it (plain
    PyTorch, any device): each block of read_blocks takes, for each of its
    rows, its windows at or above `at_least` and its first window below
    `cutoff`; the blocks of a row combine by a sum and a minimum, and the
    trim position follows from the row's windows, its first window below
    `cutoff` (0: window 0's flag) and its length. -> (trim_at int32 [R],
    n_ge int32 [R]), equal to read_counts_plain's."""
    counts, valid, nvalid = _read_window_counts(primes, k, flat, codes,
                                                lengths, big)
    R, W = counts.shape
    none = _I32_MAX
    ge = torch.zeros(R, dtype=torch.int64, device=counts.device)
    first = torch.full((R,), none, dtype=torch.int64, device=counts.device)
    j = torch.arange(W, device=counts.device)
    for r0, r1, w0, w1 in read_blocks(R, codes.shape[1], k):
        c, v = counts[r0:r1, w0:w1], valid[r0:r1, w0:w1]
        ge[r0:r1] += (v & (c >= int(at_least))).sum(dim=1)
        bad = v & (c < int(cutoff))
        first[r0:r1] = torch.minimum(first[r0:r1], torch.where(
            bad, j[w0:w1], none).amin(dim=1))
    nw = torch.clamp(nvalid, max=W)
    trim = torch.where(first < none, k + first - 1, lengths.to(torch.int64))
    trim = torch.where((nw <= 1) | (first == 0), 0, trim)
    return trim.to(torch.int32), ge.to(torch.int32)


def read_counts_cuda(primes, k, cutoff, at_least, flat, codes, lengths,
                     big=None):
    """Kernel H (csrc/read_counts.cu): read_counts_plain on the card ->
    (trim_at int32 [R], n_ge int32 [R]), tiled by read_plan; the tables
    are only read. Counts its launches in ``read_counts_cuda.launches``."""
    dev = flat.device
    _check_byte_layout(primes, flat)
    _check_rows(codes, lengths, k, dev)
    big = _big_arg(big, dev)
    R = codes.shape[0]
    trim_at = torch.empty(R, dtype=torch.int32, device=dev)
    n_ge = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return trim_at, n_ge
    plan = read_plan(codes.shape[1], k)
    scratch = None
    if plan["segs"] > 1:  # sums, first windows and a counter a tile
        scratch = torch.empty(2 * R + -(-R // plan["rows"]),
                              dtype=torch.int32, device=dev)
    keys, values = big or (None, None)
    primes_arr, offsets_arr = _layout(primes)
    err = cuda.library().khmer_read_counts(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), codes.data_ptr(), lengths.data_ptr(),
        R, codes.shape[1], int(k), _cutoff_arg(cutoff, MAX_BIGCOUNT),
        _cutoff_arg(at_least, MAX_BIGCOUNT), plan["rows"], plan["seg"],
        _ptr(keys), _ptr(values), 0 if keys is None else keys.shape[0],
        trim_at.data_ptr(), n_ge.data_ptr(), _ptr(scratch), None, dev.index,
        _stream(dev))
    cuda.check(err, "read_counts")
    read_counts_cuda.launches += 1
    return trim_at, n_ge


read_counts_cuda.launches = 0


def read_window_counts_plain(primes, k, flat, codes, lengths):
    """Kernel H's counts mode (plain PyTorch, any device): uint8 [R, L - k +
    1], each valid window's least counter over the tables (255 where
    saturated; the caller reads the bigcount map), 0 past a read's
    windows."""
    hashes, valid, _ = _window_hashes(codes, lengths, k)
    counts = byte_gather_plain(primes, flat, hashes)
    return torch.where(valid, counts, 0).to(torch.uint8)


def read_window_counts_cuda(primes, k, flat, codes, lengths):
    """Kernel H in its counts mode (csrc/read_counts.cu):
    read_window_counts_plain on the card -> uint8 [R, L - k + 1]. Counts
    its launches in ``read_window_counts_cuda.launches``."""
    dev = flat.device
    _check_byte_layout(primes, flat)
    _check_rows(codes, lengths, k, dev)
    R, L = codes.shape
    counts = torch.zeros((R, L - int(k) + 1), dtype=torch.uint8, device=dev)
    if R == 0:
        return counts
    plan = read_plan(L, k)
    primes_arr, offsets_arr = _layout(primes)
    err = cuda.library().khmer_read_counts(
        flat.data_ptr(), len(primes), ctypes.addressof(primes_arr),
        ctypes.addressof(offsets_arr), codes.data_ptr(), lengths.data_ptr(),
        R, L, int(k), 0, 0, plan["rows"], plan["seg"], None, None, 0, None,
        None, None, counts.data_ptr(), dev.index, _stream(dev))
    cuda.check(err, "read_counts")
    read_window_counts_cuda.launches += 1
    return counts


read_window_counts_cuda.launches = 0


def read_window_counts(primes, k, flat, codes, lengths):
    """Each window's least counter of rows of codes (uint8 [R, L - k + 1]):
    kernel H's counts mode on a CUDA buffer, the plain version on a CPU
    one."""
    if flat.is_cuda:
        return read_window_counts_cuda(primes, k, flat, codes, lengths)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return read_window_counts_plain(primes, k, flat, codes, lengths)


def read_counts(primes, k, cutoff, at_least, flat, codes, lengths, big=None):
    """Per-read trim positions and windows at or above `at_least` ->
    (trim_at, n_ge): kernel H on a CUDA buffer, the plain version on a CPU
    one."""
    if flat.is_cuda:
        return read_counts_cuda(primes, k, cutoff, at_least, flat, codes,
                                lengths, big)
    if flat.device.type != "cpu":
        raise ValueError("unsupported device %s" % flat.device)
    return read_counts_plain(primes, k, cutoff, at_least, flat, codes,
                             lengths, big)


# --------------------------------------------------------------------------
# histogram_add (the abundance-histogram scatter)
# --------------------------------------------------------------------------


def histogram_add_plain(out, idx):
    """out[idx[i]] += 1 as JAX's .at[].add does it: an index in
    [-len(out), 0) wraps to idx + len(out), as in numpy, and one outside
    [-len(out), len(out)) is dropped; plain PyTorch, any device."""
    nbins = out.shape[0]
    keep = (idx >= -nbins) & (idx < nbins)
    sel = torch.remainder(idx[keep], max(nbins, 1))
    out.index_add_(0, sel, torch.ones_like(sel, dtype=out.dtype))
    return out


# Kernel C (csrc/histogram.cu): blocks of HIST_THREADS threads, each
# keeping its own 32-bit counters for bins [0, HIST_LOW_BINS) in shared
# memory; these mirror its constants.
HIST_THREADS = 512           # threads a block (csrc kThreads)
HIST_PER_THREAD = 4          # indices a thread takes a loop trip (kUnroll)
HIST_LOW_BINS = 256          # csrc kLow: every count a u8 counter holds
# Blocks an SM: two, measured on an H100 (PERF.md): on abundance-dist's
# batch faster than one or four, and as fast as four on 2^21 uniform
# indices into 2^17 bins.
HIST_BLOCKS_PER_SM = 2
# Indices one launch takes: fewer than 2^31, so that no 32-bit shared
# counter overflows. The wrapper splits a longer input into launches.
HIST_LAUNCH_LIMIT = 2**31 - 1


@functools.lru_cache(maxsize=64)
def histogram_plan(n, sms):
    """Kernel C's blocks for n indices on a card of `sms` SMs:
    HIST_BLOCKS_PER_SM a SM, but no more than give each thread
    HIST_PER_THREAD indices, since each block ends with a flush of its
    nonzero private bins."""
    per_block = HIST_THREADS * HIST_PER_THREAD
    return max(1, min(int(sms) * HIST_BLOCKS_PER_SM,
                      -(-int(n) // per_block)))


def histogram_add_cuda(out, idx):
    """Kernel C (csrc/histogram.cu): histogram_add_plain on the card, for
    an int64 [nbins] `out` and 1-D int64 `idx` of any length, in launches
    of at most HIST_LAUNCH_LIMIT indices each, each on histogram_plan's
    blocks. Counts its launches in ``histogram_add_cuda.launches``."""
    dev = out.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError("histogram_add takes CUDA tensors on one device")
    if out.dtype != torch.int64 or out.dim() != 1 or not out.is_contiguous():
        raise ValueError("out must be a contiguous 1-D int64 tensor")
    if idx.dtype != torch.int64 or idx.dim() != 1 \
            or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous 1-D int64 tensor")
    n, nbins = idx.shape[0], out.shape[0]
    if n == 0 or nbins == 0:
        return out
    sms = _sm_count(dev.index)
    lib, stream = cuda.library(), _stream(dev)
    for lo in range(0, n, HIST_LAUNCH_LIMIT):
        m = min(HIST_LAUNCH_LIMIT, n - lo)
        err = lib.khmer_histogram_add(
            idx.data_ptr() + 8 * lo, m, out.data_ptr(), nbins,
            histogram_plan(m, sms), dev.index, stream)
        cuda.check(err, "histogram_add")
        histogram_add_cuda.launches += 1
    return out


histogram_add_cuda.launches = 0


def histogram_add(out, idx):
    """Accumulate the histogram of `idx` into `out`, in place: kernel C on
    CUDA tensors, the plain version on CPU ones."""
    if out.is_cuda:
        return histogram_add_cuda(out, idx.reshape(-1).contiguous())
    if out.device.type != "cpu":
        raise ValueError("unsupported device %s" % out.device)
    return histogram_add_plain(out, idx)


# --------------------------------------------------------------------------
# the consume filter: a chunk's band and mask tests, and its compaction
# (kernel S)
# --------------------------------------------------------------------------

# hashes a block of kernel S takes (csrc/consume_filter.cu kTile)
FILTER_TILE = 2048


def consume_filter_keep(hashes, nvalid, band=None, counts=None,
                        threshold=0, at_least=False):
    """Kernel S's test (plain PyTorch, any device): bool [n], true where
    hash i < nvalid lies in the band [lo, hi) (u64 order; None: every
    hash) and its mask count (int32 [n], from the mask's gather; None: no
    mask) is <= threshold, or >= threshold where `at_least` (JAX
    pipeline.py _band_filter and make_mask_filter)."""
    n = hashes.shape[0]
    keep = torch.arange(n, device=hashes.device) < int(nvalid)
    if band is not None:
        lo, hi = (to_signed(int(v)) for v in band)
        lo = torch.tensor(lo, dtype=torch.int64, device=hashes.device)
        hi = torch.tensor(hi, dtype=torch.int64, device=hashes.device)
        keep &= ~ult(hashes, lo) & ult(hashes, hi)
    if counts is not None:
        counts = counts.to(torch.int64)
        keep &= (counts >= int(threshold)) if at_least \
            else (counts <= int(threshold))
    return keep


def consume_filter_plain(hashes, nvalid, band=None, counts=None,
                         threshold=0, at_least=False):
    """Kernel S (plain PyTorch, any device): (out int64 [n], count int64
    [1]); out[:count] holds the hashes that consume_filter_keep keeps, in
    stream order, and zeros follow."""
    kept = hashes[consume_filter_keep(hashes, nvalid, band, counts,
                                      threshold, at_least)]
    out = torch.zeros_like(hashes)
    out[:kept.shape[0]] = kept
    return out, torch.tensor([kept.shape[0]], dtype=torch.int64,
                             device=hashes.device)


def consume_filter_cuda(hashes, nvalid, band=None, counts=None,
                        threshold=0, at_least=False):
    """Kernel S (csrc/consume_filter.cu): consume_filter_plain on the card
    (out[count:] is not written). Counts its launches in
    ``consume_filter_cuda.launches``."""
    dev = hashes.device
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors, not %s" % dev)
    if hashes.dtype != torch.int64 or hashes.dim() != 1 \
            or not hashes.is_contiguous():
        raise ValueError("hashes must be a contiguous 1-D int64 tensor")
    n = hashes.shape[0]
    if not 0 <= int(nvalid) <= n:
        raise ValueError("nvalid %d outside [0, %d]" % (nvalid, n))
    if counts is not None and (counts.device != dev
                               or counts.dtype != torch.int32
                               or counts.shape != (n,)
                               or not counts.is_contiguous()):
        raise ValueError("counts must be a contiguous int32 [%d] tensor on "
                         "%s" % (n, dev))
    out = torch.empty_like(hashes)
    count = torch.empty(1, dtype=torch.int64, device=dev)
    totals = torch.empty(max(-(-n // FILTER_TILE), 1), dtype=torch.int64,
                         device=dev)
    lo, hi = band if band is not None else (0, 0)
    err = cuda.library().khmer_consume_filter(
        hashes.data_ptr(), n, int(nvalid), int(band is not None),
        to_signed(int(lo)), to_signed(int(hi)), _ptr(counts),
        _cutoff_arg(threshold, _I32_MAX - 1), int(bool(at_least)),
        out.data_ptr(), count.data_ptr(), totals.data_ptr(), dev.index,
        _stream(dev))
    cuda.check(err, "consume_filter")
    consume_filter_cuda.launches += 1
    return out, count


consume_filter_cuda.launches = 0


def consume_filter(hashes, nvalid, band=None, counts=None, threshold=0,
                   at_least=False):
    """The hashes of a chunk that pass its band and mask tests, in stream
    order: (out int64 [n], count int64 [1]), out[:count] kept (see
    consume_filter_keep). Kernel S on a CUDA tensor, the plain version on
    a CPU one."""
    if hashes.is_cuda:
        return consume_filter_cuda(hashes, nvalid, band, counts, threshold,
                                   at_least)
    if hashes.device.type != "cpu":
        raise ValueError("unsupported device %s" % hashes.device)
    return consume_filter_plain(hashes, nvalid, band, counts, threshold,
                                at_least)


def _gather_counts(kind, primes, tables, hashes):
    """Count per hash (any shape) -> int32: the min over tables (byte
    tables, a ByteTables; nibble tables, a NibbleTables), or over the four
    lanes of a blocked table; 0/1 presence for bit tables."""
    if kind == "blocked":
        from khmer_tpu_torch.core import blocked

        return blocked.gather_counts(primes[0], tables, hashes)
    if kind == "byte":
        return byte_gather(primes, tables.flat, hashes)
    if kind == "bit":
        return bit_gather(primes, tables.flat, hashes)
    if kind == "nibble":
        return nibble_gather(primes, tables.flat, hashes)
    raise NotImplementedError("%s tables are not yet ported" % kind)


def pertable_counts(kind, primes, tables, hashes):
    """Every table's raw counter of a 1-D int64 hash tensor -> uint8
    [T, n] (JAX's make_pertable_get): byte tables (kernel M) and nibble
    tables (kernel R)."""
    if kind == "byte":
        return byte_pertable(primes, tables.flat, hashes)
    if kind == "nibble":
        return nibble_pertable(primes, tables.flat, hashes)
    raise NotImplementedError("%s tables are not yet ported" % kind)


# abundance-dist's histogram: bins 0..MAX_BIGCOUNT. A slot it does not
# count takes the index ABUND_BINS, one past the last bin, which
# histogram_add drops.
ABUND_BINS = MAX_BIGCOUNT + 1


def abund_batch(track_kind, track_primes, track_tables, main_kind,
                main_primes, main_tables, hashes, valid):
    """One batch of the abundance-distribution step up to its histogram:
    the tracking update (in place) with its per-event new flags, and the
    main sketch's count of each event. An event is counted iff it is new
    to tracking; only a hash's first event can be new, so no dedup is
    needed. Returns a dict of per-event tensors: counted, counts (int64),
    is_sat (counted at MAX_KCOUNT) and idx, the histogram index: the count
    where counted and not saturated, else ABUND_BINS."""
    if track_kind != "bit":
        raise NotImplementedError("%s tracking tables are not yet ported"
                                  % track_kind)
    counted = bit_update(track_primes, track_tables,
                         torch.zeros(1, dtype=torch.int64,
                                     device=hashes.device),
                         hashes, hashes.shape[0], valid)
    if main_kind == "nibble":  # only the counted events load (kernel Q)
        counts = nibble_gather(main_primes, main_tables.flat, hashes,
                               mask=counted)
    else:
        counts = _gather_counts(main_kind, main_primes, main_tables, hashes)
    counts = counts.to(torch.int64)
    is_sat = counted & (counts == MAX_KCOUNT)
    return {"counted": counted, "counts": counts, "is_sat": is_sat,
            "idx": torch.where(counted & ~is_sat, counts, ABUND_BINS)}


def make_abund_dist(track_kind, track_primes, main_kind, main_primes,
                    collect_sat=False):
    """Abundance-distribution step (reference hashtable.cc:451-502).

    step(track_tables, dist, main_tables, hashes, valid) -> (n_sat,
    sat_hash): per event, in order, if the tracking count is 0, add to
    tracking and histogram the main sketch's count. Updates the tracking
    tables and ``dist`` [ABUND_BINS] in place (JAX donated both) and
    returns the number of saturated counts (count == MAX_KCOUNT) as a
    device scalar. Those belong in bin 255 unless a bigcount map resolves
    them: with `collect_sat`, sat_hash holds their hashes (a host sync per
    step); else it is None.
    """
    track_primes = tuple(int(p) for p in track_primes)
    main_primes = tuple(int(p) for p in main_primes)

    def step(track_tables, dist, main_tables, hashes, valid):
        b = abund_batch(track_kind, track_primes, track_tables, main_kind,
                        main_primes, main_tables, hashes, valid)
        histogram_add(dist, b["idx"])
        is_sat = b["is_sat"]
        return is_sat.sum(), (hashes[is_sat] if collect_sat else None)

    return step


def bit_occupied(table0):
    """Set bits of a bit table (a device scalar), counted a slice of
    OCCUPIED_SLICE bytes at a time, as byte_occupied: one int64 copy of
    a 1 GB table (-x 8e9) would take 8 GB of device memory."""
    pop = _POPCOUNT.to(table0.device)
    total = torch.zeros((), dtype=torch.int64, device=table0.device)
    for lo in range(0, table0.shape[0], OCCUPIED_SLICE):
        total += pop[table0[lo:lo + OCCUPIED_SLICE].to(torch.int64)].sum()
    return total


def init_tables(kind, primes, device):
    """Zeroed tables for a storage kind on `device`."""
    if kind == "blocked":
        from khmer_tpu_torch.core import blocked

        return tuple(torch.zeros((int(p), blocked.LANES), dtype=torch.uint8,
                                 device=device) for p in primes)
    if kind == "bit":
        return BitTables(torch.zeros(bit_flat_size(primes),
                                     dtype=torch.uint8, device=device),
                         primes)
    if kind == "byte":
        return ByteTables(torch.zeros(byte_flat_size(primes),
                                      dtype=torch.uint8, device=device),
                          primes)
    if kind == "nibble":
        return NibbleTables(torch.zeros(nibble_flat_size(primes),
                                        dtype=torch.uint8, device=device),
                            primes)
    raise NotImplementedError("%s tables are not yet ported" % kind)


def get_n_primes_near_x(n_tables: int, x: int):
    """Descending primes just below x.

    Reference: hashtable.hh:99-123 / khmer/__init__.py:56-83 (which
    accepts float x and raises RuntimeError when too few primes fit).
    """
    x = int(x)
    if x == 1 and n_tables == 1:
        return [1]

    def is_prime(num):
        if num < 2:
            return False
        if num == 2:
            return True
        if num % 2 == 0:
            return False
        i = 3
        while i * i <= num:
            if num % i == 0:
                return False
            i += 2
        return True

    primes = []
    i = x - 1
    if i % 2 == 0:
        i -= 1
    while len(primes) != n_tables and i > 0:
        if is_prime(i):
            primes.append(i)
        if i == 1:
            break
        i -= 2
    if len(primes) != n_tables:
        raise RuntimeError("unable to find %d prime numbers < %d"
                           % (n_tables, x))
    return primes
