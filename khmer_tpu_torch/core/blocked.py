"""Blocked Count-Min sketch — counterpart of khmer_tpu/core/blocked.py.

All of a k-mer's counters sit inside ONE 128-byte block:

    table[nblocks, 128] uint8
    block  = hash % nblocks          (nblocks prime)
    lane_t = 32*t + bits_t(mix64(hash))   for t in 0..3

Counting semantics as defined for this layout: saturating 8-bit
counters, count() = min over the four lanes, an add is a new k-mer iff
some lane was zero at that moment (sequential order). No bigcount.
Files are OXLI-framed with the private type byte 127.

Each operation on the hot path has a plain PyTorch version and a
hand-written CUDA kernel (csrc/); the dispatching function runs the
kernel on a CUDA tensor and the plain version only on a CPU tensor.
"""

import struct

import numpy as np
import torch

from khmer_tpu_torch.core import oxli_io
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.sketch import (_MurmurMixin, _Sketch,
                                         _resolve_device)
from khmer_tpu_torch.ops import cuda
from khmer_tpu_torch.ops.u64 import mix64, srl, umod

LANES = 128
SUB = 4          # sub-counters per block
QUART = LANES // SUB
SAVED_BLOCKED = 127  # private OXLI type byte (reference uses 1..8)

MAX_BLOCKS = (2**31 - 1) // LANES  # counter ids must stay i32

IDX_FILL = K.IDX_FILL  # plain winner sentinel; events per batch stay below


def _offsets(h):
    """Per-sub-counter lane offsets within the 32-lane quarter: [SUB, M]."""
    m = mix64(h)
    return torch.stack([srl(m, 5 * t) & (QUART - 1) for t in range(SUB)])


def _lane_index(block, offq):
    """Flat table index of each event's four counters: [SUB, M].

    Takes the place of JAX's _select_lanes, which picked the lanes out of
    gathered 128-byte rows with one-hot masks; PyTorch indexes the lanes
    directly."""
    quarter = QUART * torch.arange(SUB, device=block.device)[:, None]
    return block[None, :] * LANES + quarter + offq


def blocked_local_update(span, table, hashes, block, idx, mine):
    """Sort-free batch update of a [span, LANES] table (plain PyTorch).

    `block`/`mine` select which events this table owns; `idx` is the
    event's position in the sequential stream order. Reproduces
    sequential ByteStorage::add semantics (storage.hh:571-624, as
    defined for this layout):
      * counts: saturating +1 increments commute, so one scatter-add of
        per-lane totals followed by a clamp equals the sequential result;
      * new-k-mer credit: an event is new iff it is the minimum-`idx`
        toucher of a lane whose pre-batch value is zero — one scatter-min
        of event indices decides every lane's winner, and duplicates of a
        hash can never out-rank its first occurrence.

    Returns (new_table, new_flags [M] bool); `table` is not modified.
    """
    M = hashes.shape[0]
    if M >= IDX_FILL:
        raise ValueError("blocked batch too large: %d events (max %d)"
                         % (M, IDX_FILL - 1))
    dev = table.device
    sel = torch.nonzero(mine).squeeze(1)
    lanes = _lane_index(block[sel].to(torch.int64),
                        _offsets(hashes[sel]))            # [SUB, n]
    flat = lanes.reshape(-1)
    ev = idx[sel].to(torch.int32)
    # per-lane batch totals and first-toucher event index
    delta = torch.zeros(span * LANES, dtype=torch.int32, device=dev)
    delta.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    winner = torch.full((span * LANES,), IDX_FILL, dtype=torch.int32,
                        device=dev)
    winner.scatter_reduce_(0, flat, ev.repeat(SUB), "amin")
    old = table.reshape(-1)
    fresh_won = (old[lanes] == 0) & (winner[lanes] == ev[None, :])
    new_flags = torch.zeros(M, dtype=torch.bool, device=dev)
    new_flags[sel] = torch.any(fresh_won, dim=0)
    new_table = delta.add_(old).clamp_(max=K.MAX_KCOUNT).to(torch.uint8)
    return new_table.view(span, LANES), new_flags


def blocked_update_plain(nblocks, tables, n_unique, hashes, nvalid):
    """Plain PyTorch blocked update of hashes[:nvalid], on any device.

    Updates tables[0] and n_unique (i64[1]) in place (JAX donated the
    table) and returns the per-event new flags [M] bool.
    """
    NB = int(nblocks)
    M = hashes.shape[0]
    valid = torch.arange(M, device=hashes.device) < nvalid
    block = umod(hashes, NB)
    idx = torch.arange(M, dtype=torch.int32, device=hashes.device)
    new_table, new_flags = blocked_local_update(
        NB, tables[0], hashes, block, idx, valid)
    tables[0].copy_(new_table)
    n_unique += new_flags.sum()
    return new_flags


def _check_blocked_args(table, hashes, device):
    if device.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors, not %s"
                         % device)
    if table.device != device or hashes.device != device:
        raise ValueError("table and hashes must be on %s" % device)
    if (table.dtype != torch.uint8 or table.dim() != 2
            or table.shape[1] != LANES or not table.is_contiguous()):
        raise ValueError("table must be a contiguous [nblocks, %d] uint8 "
                         "tensor" % LANES)
    if hashes.dtype != torch.int64 or hashes.dim() != 1 \
            or not hashes.is_contiguous():
        raise ValueError("hashes must be a contiguous 1-D int64 tensor")


def blocked_update_cuda(table, hashes, nvalid, n_unique, scratch=None):
    """Kernel 1 (csrc/blocked_update.cu): the blocked update on the card.

    Updates `table` [nblocks, 128] u8 and `n_unique` i64[1] in place with
    hashes[:nvalid] and returns the new flags [M] bool. `scratch` is a
    uint8 buffer on the card of at least update_plan(nvalid, 4) bytes
    (sketch_kernels.update_scratch; a sketch keeps one between chunks), or
    None for a new one: nothing the size of the table. Counts its
    launches in ``blocked_update_cuda.launches``.
    """
    dev = table.device
    _check_blocked_args(table, hashes, dev)
    M = hashes.shape[0]
    n = int(nvalid)
    if not 0 <= n <= M:
        raise ValueError("nvalid %d outside [0, %d]" % (n, M))
    if (n_unique.device != dev or n_unique.dtype != torch.int64
            or n_unique.numel() != 1):
        raise ValueError("n_unique must be an int64 [1] tensor on %s" % dev)
    if n == 0:
        return torch.zeros(M, dtype=torch.bool, device=dev)
    # held until the launch: the allocator may not hand it out meanwhile
    scratch = K.update_scratch(scratch, n, SUB, dev)
    nbuckets, ptr = K._scratch_ptrs(scratch, n, SUB)
    flags = torch.empty(M, dtype=torch.bool, device=dev)
    err = cuda.library().khmer_blocked_update(
        table.data_ptr(), table.shape[0], hashes.data_ptr(), M, n, nbuckets,
        *ptr[:4], flags.data_ptr(), n_unique.data_ptr(), dev.index,
        K._stream(dev))
    cuda.check(err, "blocked_update")
    blocked_update_cuda.launches += 1
    return flags


blocked_update_cuda.launches = 0


def blocked_update_core(nblocks, tables, n_unique, hashes, nvalid,
                        scratch=None):
    """Batch update of hashes[:nvalid], sequential-order exact, in place.

    On a CUDA table this launches kernel 1 (with the sketch's `scratch`,
    see blocked_update_cuda); on a CPU table it runs the plain version.
    Returns the per-event new flags.
    """
    table = tables[0]
    if table.shape[0] != int(nblocks):
        raise ValueError("table has %d blocks, expected %d"
                         % (table.shape[0], nblocks))
    if table.is_cuda:
        return blocked_update_cuda(table, hashes, nvalid, n_unique, scratch)
    if table.device.type != "cpu":
        raise ValueError("unsupported device %s" % table.device)
    return blocked_update_plain(nblocks, tables, n_unique, hashes, nvalid)


def gather_counts_plain(nblocks, tables, hashes):
    """Min-over-lanes counts for a hash tensor (any shape) -> int32,
    plain PyTorch on any device."""
    NB = int(nblocks)
    flat = hashes.reshape(-1)
    lanes = _lane_index(umod(flat, NB), _offsets(flat))
    counts = tables[0].reshape(-1)[lanes].amin(dim=0)
    return counts.to(torch.int32).reshape(hashes.shape)


def blocked_gather_cuda(table, hashes):
    """Kernel 2 (csrc/blocked_gather.cu): min-over-lanes counts of a 1-D
    int64 hash tensor -> int32 [n]. Counts its launches in
    ``blocked_gather_cuda.launches``."""
    dev = table.device
    _check_blocked_args(table, hashes, dev)
    n = hashes.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    err = cuda.library().khmer_blocked_gather(
        table.data_ptr(), table.shape[0], hashes.data_ptr(), n,
        out.data_ptr(), dev.index,
        K._stream(dev))
    cuda.check(err, "blocked_gather")
    blocked_gather_cuda.launches += 1
    return out


blocked_gather_cuda.launches = 0


def gather_counts(nblocks, tables, hashes):
    """Min-over-lanes counts for a hash tensor (any shape) -> int32.

    Launches kernel 2 on a CUDA table, the plain version on a CPU one."""
    table = tables[0]
    if table.shape[0] != int(nblocks):
        raise ValueError("table has %d blocks, expected %d"
                         % (table.shape[0], nblocks))
    if table.is_cuda:
        flat = hashes.reshape(-1).contiguous()
        return blocked_gather_cuda(table, flat).reshape(hashes.shape)
    if table.device.type != "cpu":
        raise ValueError("unsupported device %s" % table.device)
    return gather_counts_plain(nblocks, tables, hashes)


def _proto_lanes(bids, offs, nblocks):
    """Decoded events of the prototype (scripts/pallas_proto.py): the
    valid events' indices, their flat lane indices [SUB, n] and a mask of
    the lanes that repeat an earlier lane of the same event."""
    valid = (bids >= 0) & (bids < int(nblocks))
    ev = torch.nonzero(valid).squeeze(1)
    offs_v = offs[ev].to(torch.int64)
    o = torch.stack([(offs_v >> (8 * j)) & (LANES - 1) for j in range(SUB)])
    repeated = torch.zeros_like(o, dtype=torch.bool)
    for j in range(1, SUB):
        for k in range(j):
            repeated[j] |= o[j] == o[k]
    return ev, bids[ev].to(torch.int64)[None, :] * LANES + o, repeated


def proto_rmw_plain(bids, offs, table):
    """The fused blocked read-modify-write of scripts/pallas_proto.py:44
    (make_kernel) over decoded events, in place (plain PyTorch, any
    device).

    Event i (int32 bids[i], its block, < 0 or >= nblocks invalid; int32
    offs[i], four lane offsets of 8 bits each, & 127) increments each lane
    of its SET of lanes by one, capped at 255, in stream order; returns
    nnew (i64 [1]), the valid events that found one of their lanes at 0.
    Set semantics follow the Pallas kernel, which ORs the one-hots
    (:87-93): a repeated offset is incremented once. The script's numpy
    oracle (:160-162) would increment it twice; the two agree on the
    script's inputs, which put one lane in each quarter.
    """
    nb = table.shape[0]
    dev = table.device
    ev, lanes, repeated = _proto_lanes(bids, offs, nb)
    winner = torch.full((nb * LANES,), IDX_FILL, dtype=torch.int64,
                        device=dev)
    winner.scatter_reduce_(0, lanes.reshape(-1),
                           ev.repeat(SUB), "amin")
    old = table.reshape(-1)
    fresh = ((old[lanes] == 0) & (winner[lanes] == ev[None, :])).any(dim=0)
    once = lanes[~repeated]
    delta = torch.zeros(nb * LANES, dtype=torch.int32, device=dev)
    delta.index_add_(0, once, torch.ones_like(once, dtype=torch.int32))
    table.copy_(delta.add_(old).clamp_(max=K.MAX_KCOUNT).to(
        torch.uint8).view_as(table))
    return fresh.sum().reshape(1)


def proto_rmw_cuda(bids, offs, table, scratch=None):
    """Kernel D (csrc/proto_rmw.cu): proto_rmw_plain on the card.

    `scratch` is a uint8 buffer on the card of at least update_plan(m, 4)
    bytes for the m events (sketch_kernels.update_scratch), or None for a
    new one: nothing the size of the table. Raises when m events of four
    lanes pass the update's limit (m * 4 < 2^31). Returns nnew (i64 [1],
    on the card). Counts its launches in ``proto_rmw_cuda.launches``.
    """
    dev = table.device
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors, not %s" % dev)
    if (table.dtype != torch.uint8 or table.dim() != 2
            or table.shape[1] != LANES or not table.is_contiguous()):
        raise ValueError("table must be a contiguous [nblocks, %d] uint8 "
                         "tensor" % LANES)
    for name, t in (("bids", bids), ("offs", offs)):
        if (t.device != dev or t.dtype != torch.int32 or t.dim() != 1
                or not t.is_contiguous() or t.shape != bids.shape):
            raise ValueError("%s must be a contiguous 1-D int32 tensor of "
                             "one entry per event on %s" % (name, dev))
    M = bids.shape[0]
    K.update_plan(M, SUB)  # raises past the update's limit
    nnew = torch.zeros(1, dtype=torch.int64, device=dev)
    if M == 0:
        return nnew
    # held until the launch: the allocator may not hand it out meanwhile
    scratch = K.update_scratch(scratch, M, SUB, dev)
    nbuckets, ptr = K._scratch_ptrs(scratch, M, SUB)
    err = cuda.library().khmer_proto_rmw(
        bids.data_ptr(), offs.data_ptr(), M, table.data_ptr(),
        table.shape[0], nbuckets, *ptr[:4], nnew.data_ptr(), dev.index,
        K._stream(dev))
    cuda.check(err, "proto_rmw")
    proto_rmw_cuda.launches += 1
    return nnew


proto_rmw_cuda.launches = 0


def proto_rmw(bids, offs, table, scratch=None):
    """The prototype's read-modify-write, in place: kernel D on a CUDA
    table (with `scratch`, see proto_rmw_cuda), the plain version on a CPU
    one."""
    if table.is_cuda:
        return proto_rmw_cuda(bids, offs, table, scratch)
    if table.device.type != "cpu":
        raise ValueError("unsupported device %s" % table.device)
    return proto_rmw_plain(bids, offs, table)


def _blocked_occupied(table):
    """Occupancy proxy: nonzero counters of sub-table 0 (lanes 0..31)."""
    return (table[:, :QUART] != 0).sum()


class _BlockedBase(_Sketch):
    """Blocked Count-Min of either hash family (khmer_tpu _BlockedBase).

    Constructor signature matches Countgraph(k, starting_size, n_tables)
    plus the device: total memory = starting_size * n_tables bytes,
    arranged as a prime count of 128-byte blocks. Its counts (get and the
    sequence count ops of _Sketch) come from kernel 2.
    """

    storage_kind = "blocked"

    def __init__(self, ksize, starting_size, n_tables=SUB, primes=None, *,
                 device="cuda"):
        if primes is not None:
            nblocks = int(primes[0])
        else:
            want = max(int(starting_size) * max(int(n_tables), 1)
                       // LANES, 4)
            nblocks = K.get_n_primes_near_x(1, want + 1)[0]
        if nblocks > MAX_BLOCKS:
            raise ValueError("blocked sketch too large: %d blocks (max "
                             "%d)" % (nblocks, MAX_BLOCKS))
        super().__init__(ksize, (nblocks,), device=device)

    @property
    def nblocks(self):
        return self._primes[0]

    def hashsizes(self):
        # four sub-tables of nblocks*32 counters each (so the FP-rate
        # guard computes (occupancy/subtable_size)**4 meaningfully)
        return [self._primes[0] * QUART] * SUB

    def _update(self, hashes, nvalid):
        blocked_update_core(self.nblocks, self.tables, self._n_unique,
                            hashes, nvalid, self._update_scratch(nvalid, SUB))

    def _count_nonzero_t0(self):
        return int(_blocked_occupied(self.tables[0]))

    # -- persistence (OXLI-framed extension format) -----------------------

    def save(self, filename):
        raw = self.tables[0].cpu().numpy()
        with oxli_io._open_write(filename) as f:
            f.write(oxli_io.SAVED_SIGNATURE)
            f.write(bytes([oxli_io.SAVED_FORMAT_VERSION, SAVED_BLOCKED]))
            f.write(struct.pack("<IQQ", self.ksize(), self.nblocks,
                                self.n_occupied()))
            f.write(raw.tobytes())

    @classmethod
    def load(cls, filename, *, device="cuda"):
        with oxli_io._open_read(filename) as f:
            oxli_io._check_header(f, SAVED_BLOCKED, filename,
                                  "blocked count sketch")
            ksize, nblocks, occupied = struct.unpack("<IQQ", f.read(20))
            data = f.read(nblocks * LANES)
            if len(data) != nblocks * LANES:
                raise OSError("Unexpected end of k-mer count file")
        table = np.frombuffer(data, np.uint8).reshape(nblocks, LANES)
        obj = from_numpy_state(ksize, table, 0, 0, device, cls=cls)
        obj._occupied_offset = occupied - obj._count_nonzero_t0()
        return obj


class BlockedCountgraph(_BlockedBase):
    """Blocked Count-Min with the 2-bit hash (khmer_tpu BlockedCountgraph;
    its graph half is not ported yet)."""


class BlockedCounttable(_MurmurMixin, _BlockedBase):
    """Blocked Count-Min with the murmur hash (khmer_tpu
    BlockedCounttable, blocked.py:276)."""


def from_numpy_state(ksize, table_u8, n_unique, occupied_offset,
                     device="cuda", cls=None):
    """A BlockedCountgraph (or a sketch of class `cls`) holding the given
    state: the [nblocks, 128] uint8 table (e.g.
    ``np.asarray(jax_cg.tables[0])``), the unique count and the
    loaded-occupancy offset, on `device`."""
    table = np.ascontiguousarray(table_u8, dtype=np.uint8)
    if table.ndim != 2 or table.shape[1] != LANES:
        raise ValueError("table must be [nblocks, %d] uint8" % LANES)
    obj = (cls or BlockedCountgraph)(ksize, 1, 1, primes=(table.shape[0],),
                                     device=_resolve_device(device))
    obj.tables[0].copy_(torch.from_numpy(table.copy()))
    obj._n_unique.fill_(int(n_unique))
    obj._occupied_offset = int(occupied_offset)
    return obj
