"""Tag-graph partitioning — counterpart of khmer_tpu/core/partition.py
(reference src/oxli/subset.cc, include/oxli/subset.hh).

A partition walks the implicit de Bruijn graph from each tag, in breadth
levels up to 2 * tag_density + 1, and records the other tags it meets
(find_all_tags); a union-find over the tags then joins those that met
(SubsetPartition). Work is cut into tag-range subsets whose partition
maps (.pmap, OXLI type 5) merge afterwards; reads are then annotated
with the partition of their first tag.

The graph is read-only while it is walked, so a batch of traversals
advances one level a pass: the host's C++ (csrc/tag_walk.cc, ops/host.py
TagWalk) walks a level of every traversal and hands out the survivors,
and kernel L (csrc/neighbors.cu) probes all their neighbours at once in
the tables on the card, one byte a node. The loop over levels runs in C++
too (csrc/level_walk.cc kt_level_run, _Prober.run), each level's probe a C
call on a context made once a walk (sketch_kernels.LevelProbe); on the
CPU the probe is a callback that runs the plain version. The union-find
mirrors the reference's
pointer aliasing (subset.cc:630-788), so partition ids come out the same
as in JAX and in khmer.

The walk follows the reference's queue rule, as JAX's native engine
(KHMER_TPU_ENGINE=auto) does; find_all_tags_plain, the queue walk one node
at a time in Python, is its plain reference, which only the tests run. On
a Countgraph the probe is kernel N (csrc/neighbors.cu,
sketch_kernels.byte_neighbors; on a SmallCountgraph its nibble mode,
sketch_kernels.nibble_neighbors), which also gives the abundance-truncated
walk (do_partition_with_abundance) each neighbour's verdict against the
band; each start's count comes from kernel B with the bigcount map. The
perimeter sweep (sweep_for_tags) runs a batch of sequences the same way,
a level a pass (csrc/sweep_walk.cc), with sweep_for_tags_plain as its
plain reference.

The knot pipeline's repartition (repartition_largest_partition, the
reference's subset.cc:1218-1359) walks an excursion of bounded radius from
each tag of the largest partition, in JAX one tag after another: a tag's
walk skips the stop tags the tags before it added, and its counts hold
their adds. Here the excursions go in batches (core/traversal.py
walk_excursions, csrc/excursion_walk.cc) walked against the stop tags as
they stood when the batch began; the host then evaluates the batch's tags
in order, walking again (from the neighbour bytes it recorded, without the
card) each tag whose walk kept a stop tag that an earlier tag of the batch
added, and reading each k-mer's counters from one gather of the tables
(kernel M, sketch_kernels.pertable_counts, its keepers up and counters
back through pinned buffers, _Staging) plus the batch's earlier adds;
kernel A commits the batch's adds in one call, in JAX's order. The answer
does not depend on the batch.
"""

import ctypes
import re
import struct

import numpy as np
import torch

from khmer_tpu_torch.core.graphmixin import check_probe_kind
from khmer_tpu_torch.ops import hashing as H

BIG_TRAVERSALS_ARE = 200  # reference: subset.cc:54
# A TagWalk takes a batch of at most WALK_BATCH start tags, the first
# batch at most FIRST_BATCH; its traversals' keepers stay in host memory
# until the batch ends, so each later batch takes as many as KEEPER_BYTES
# holds at the keeper bytes a traversal of the batch before it reached.
WALK_BATCH = 1 << 14
FIRST_BATCH = 1 << 11
KEEPER_BYTES = 1 << 30
# The excursions of a repartition go in batches of at most REPART_BATCH
# tags, the first at most REPART_FIRST, each later one sized to
# KEEPER_BYTES as the walk's batches are.
REPART_BATCH = 1 << 12
REPART_FIRST = 1 << 9


class _Box:
    """A PartitionID 'pointer' (aliasable box)."""

    __slots__ = ("pid",)

    def __init__(self, pid):
        self.pid = pid

    def __repr__(self):
        return "<pid %d>" % self.pid


def _sorted_tags(tags):
    arr = np.fromiter(tags, np.uint64, len(tags))
    arr.sort()
    return arr


def _index(sorted_tags, tag):
    """The position of `tag` in the ascending array (ValueError if it is
    not there, as list.index raises)."""
    i = int(np.searchsorted(sorted_tags, np.uint64(tag)))
    if i == len(sorted_tags) or int(sorted_tags[i]) != int(tag):
        raise ValueError("%d is not a tag" % int(tag))
    return i


def revcomp_bits(f, k):
    """The reverse-complement word r of each forward 2-bit word f
    (numpy u64): the start (f, r) of a walk from a canonical tag."""
    f = np.asarray(f, dtype=np.uint64).copy()
    r = np.zeros_like(f)
    for _ in range(k):
        r = (r << np.uint64(2)) | ((f & np.uint64(3)) ^ np.uint64(1))
        f >>= np.uint64(2)
    return r


def plain_count(graph):
    """A function of a canonical k-mer to its count in the graph's tables,
    read one table at a time in Python: on a Nodegraph 1 where every
    table's bit is set, else 0; on a Countgraph the least counter, a 255
    read through the bigcount map where the graph uses one; on a
    SmallCountgraph the least 4-bit counter."""
    from khmer_tpu_torch.core import sketch_kernels as K

    flat = graph.tables.flat.cpu().numpy()
    primes = [int(p) for p in graph._primes]
    if graph.storage_kind == "bit":
        layout = [(p, 8 * o) for p, o in zip(primes, K.bit_offsets(primes))]

        def count(c):
            return int(all(flat[(o + c % p) >> 3] >> ((o + c % p) & 7) & 1
                           for p, o in layout))
        return count
    if graph.storage_kind == "nibble":
        layout = [(p, 2 * o) for p, o in zip(primes,
                                             K.nibble_offsets(primes))]

        def nibble(i):
            v = int(flat[i >> 1])
            return v & 0xF if i & 1 else v >> 4

        def count(c):
            return min(nibble(o + c % p) for p, o in layout)
        return count
    layout = list(zip(primes, K.byte_offsets(primes)))
    big = graph._bigcounts if graph._use_bigcount else {}

    def count(c):
        m = min(int(flat[o + c % p]) for p, o in layout)
        return big.get(c, m) if m == K.MAX_KCOUNT else m
    return count


def _children(f, r, k):
    """The neighbours (nf, nr) of (f, r), in the reference's queue order:
    to the right, then to the left, the bases A, C, G, T."""
    mask = (1 << (2 * k)) - 1
    shift = 2 * k - 2
    for b in (0, 2, 3, 1):
        yield ((f << 2) | b) & mask, (r >> 2) | ((b ^ 1) << shift)
    for b in (0, 2, 3, 1):
        yield (f >> 2) | (b << shift), ((r << 2) | (b ^ 1)) & mask


def find_all_tags_plain(graph, starts, break_on_stop_tags=False,
                        stop_big_traversals=False, count_range=None):
    """The plain reference of find_all_tags_batch: the reference's queue
    walk (subset.cc:213-300, as JAX's native engine's find_all_tags_one
    runs it), one traversal and one node at a time in Python, each
    neighbour's count read from the tables one by one (plain_count).
    starts: (f, r) pairs. count_range=(lo, hi): the abundance-truncated
    walk (subset.cc:399-496), a popped node whose count lies outside the
    closed band is dropped before it is kept. Returns a list of tag
    sets."""
    from collections import deque

    k = graph.ksize()
    count = plain_count(graph)
    max_breadth = 2 * graph._tag_density + 1

    out = []
    for f0, r0 in starts:
        queue = deque([(int(f0), int(r0), 0)])
        keeper = set()
        tagged = set()
        first = True
        while queue:
            if stop_big_traversals and len(keeper) > BIG_TRAVERSALS_ARE:
                tagged = set()
                break
            f, r, breadth = queue.popleft()
            c = min(f, r)
            if c in keeper:
                continue
            if break_on_stop_tags and c in graph.stop_tags:
                continue
            if count_range is not None and not (
                    count_range[0] <= count(c) <= count_range[1]):
                continue
            keeper.add(c)
            if not first and c in graph.all_tags:
                tagged.add(c)
                continue
            if breadth >= max_breadth:
                continue
            for nf, nr in _children(f, r, k):
                nc = min(nf, nr)
                if count(nc) > 0 and nc not in keeper:
                    queue.append((nf, nr, breadth + 1))
            first = False
        out.append(tagged)
    return out


def sweep_for_tags_plain(graph, seq, sweep_range=0, break_on_stop_tags=False,
                         stop_big_traversals=False):
    """The plain reference of sweep_for_tags: the reference's perimeter
    sweep (subset.cc:305-394) as JAX's native engine runs it
    (hg_sweep_for_tags), one node at a time in Python, each neighbour's
    count read from the tables one by one. Returns (the tags found, as a
    set, the nodes counted)."""
    from collections import deque

    k = graph.ksize()
    count = plain_count(graph)
    traversed = set()
    tagged = set()
    queue = deque()
    if len(seq) >= k:
        _, f, r = H.rolling_hash_windows(
            torch.from_numpy(H.encode_dna(seq)), k)
        for f, r in zip(f.numpy().view(np.uint64).tolist(),
                        r.numpy().view(np.uint64).tolist()):
            traversed.add(min(f, r))
            queue.append((f, r, 0))
    big_perimeter = BIG_TRAVERSALS_ARE * (len(queue) // 2)
    total = 0
    while True:
        if stop_big_traversals and len(traversed) > big_perimeter:
            tagged = set()
            break
        node = None
        while queue:
            f, r, breadth = queue.popleft()
            c = min(f, r)
            if break_on_stop_tags and c in graph.stop_tags:
                continue
            traversed.add(c)
            total += 1
            if c in graph.all_tags:
                tagged.add(c)
                continue
            if breadth == sweep_range:
                continue
            if breadth > sweep_range:
                return tagged, total
            node = (f, r, breadth)
            break
        if node is None:
            break
        f, r, breadth = node
        for nf, nr in _children(f, r, k):
            nc = min(nf, nr)
            if count(nc) > 0 and nc not in traversed:
                queue.append((nf, nr, breadth + 1))
    return tagged, total


class _Prober:
    """The neighbour probe of each level of a walk: kernel L on a
    Nodegraph's bit tables, kernel N on a Countgraph's byte tables, its
    nibble mode on a SmallCountgraph's nibble tables. With a band (lo,
    hi), each level also gives each node's band byte (bit j set iff
    neighbour j's count lies in [lo, hi]): from kernel N's band mode, with
    the bigcount map where the graph uses one (on 4-bit counts in the
    nibble mode, which saturate at 15); on a Nodegraph, whose
    present k-mers count 1, the presence byte where the band holds 1, else
    0.

    run(walk) walks a TagWalk or SweepWalk to its end in C++ against the
    entry (probe, block, ctx): on the card the C probe of a
    sketch_kernels.LevelProbe made once, on the CPU a callback that runs
    the plain versions (chosen by the tables' device). A call (walk, n)
    probes one frontier from Python instead, for a walk stepped a level at
    a time (traversal.walk_excursions): the frontier up as one int64
    tensor (f's then r's), the masks back a byte a node, through pinned
    host buffers that grow as frontiers do."""

    def __init__(self, graph, band=None):
        from khmer_tpu_torch.core import sketch_kernels as K
        from khmer_tpu_torch.ops.host import PROBE_FN

        check_probe_kind(graph)
        self.graph = graph
        self.dev = graph.tables.flat.device
        self.cuda = self.dev.type == "cuda"
        self.band = band
        self.kind = graph.storage_kind
        self.byte = self.kind == "byte"
        self.big = None
        if self.byte and band is not None and graph._use_bigcount \
                and graph._bigcounts:
            self.big = K.bigcount_table(graph._bigcounts, self.dev)
        self._up = self._down = None
        self.card = None
        self._error = None
        if self.cuda:
            self.card = K.LevelProbe(graph._primes, graph.tables.flat,
                                     graph.ksize(), self.kind, band,
                                     self.big)
            self.probe = self.card.probe
            self.block = self.card.block
            self.ctx = self.card.ctx
        elif self.dev.type == "cpu":
            self.probe = PROBE_FN(self._plain_level)
            self.block = self.ctx = None
        else:
            raise ValueError("unsupported device %s" % self.dev)

    def run(self, walk):
        """Walk `walk` to its end, each level probed by the entry (probe,
        block, ctx); raises if a probe fails."""
        from khmer_tpu_torch.ops import cuda
        from khmer_tpu_torch.ops.host import ProbeError

        self._error = None
        try:
            walk.run(self.probe, self.block, self.ctx)
        except ProbeError as e:
            if self._error is not None:
                raise self._error from e
            if self.cuda and e.code > 0:
                cuda.check(e.code, "the walk's probe")
            raise
        finally:
            if self.card is not None:
                self.card.count()

    def _plain_level(self, ctx, fr, n, masks, band):
        """The CPU's probe of a level (ops/host.PROBE_FN): the plain
        versions on the frontier at `fr`, the bytes into `masks` and, in a
        banded walk, `band`. An exception ends the walk (run raises it)."""
        try:
            front = torch.frombuffer((ctypes.c_int64 * (2 * n)).from_address(
                fr), dtype=torch.int64)
            got, got_band = self._probe(front[:n], front[n:])
            for out, part in ((masks, got), (band, got_band)):
                if out:
                    np.frombuffer((ctypes.c_uint8 * n).from_address(out),
                                  np.uint8)[:] = part.numpy()
            return 0
        except Exception as e:  # the C++ loop's boundary: stop the walk
            self._error = e
            return 1

    def close(self):
        if self.card is not None:
            self.card.close()

    def _buffers(self, n):
        if self._up is None or self._up.shape[0] < 2 * n:
            cap = max(2 * n, 1 << 16)
            self._up = torch.empty(cap, dtype=torch.int64,
                                   pin_memory=self.cuda)
            self._down = torch.empty(cap, dtype=torch.uint8,
                                     pin_memory=self.cuda)
        return self._up, self._down

    def _probe(self, f, r):
        """The presence bytes of the nodes (f, r) on the device, and with a
        band their band bytes (None without)."""
        from khmer_tpu_torch.core import sketch_kernels as K

        g = self.graph
        k = g.ksize()
        if self.kind == "nibble":
            return _pair(K.nibble_neighbors(g._primes, g.tables.flat, f, r,
                                            k, self.band))
        if not self.byte:
            masks = K.neighbors(g._primes, g.tables.flat, f, r, k)
            if self.band is None:
                return masks, None
            lo, hi = self.band
            return masks, masks if lo <= 1 <= hi else torch.zeros_like(masks)
        if self.band is None:
            return K.byte_neighbors(g._primes, g.tables.flat, f, r, k), None
        return K.byte_neighbors(g._primes, g.tables.flat, f, r, k, self.band,
                                self.big)

    def __call__(self, walk, n):
        """The present-neighbour bytes of the walk's frontier of n
        nodes (numpy uint8 [n]); with a band, (those, the band bytes)."""
        up, down = self._buffers(n)
        walk.frontier(up.numpy().view(np.uint64))
        fr = up[:2 * n].to(self.dev, non_blocking=True)
        masks, band = self._probe(fr[:n], fr[n:])
        out = down[:n]
        out.copy_(masks, non_blocking=True)
        if band is not None:
            down[n:2 * n].copy_(band, non_blocking=True)
        if self.cuda:
            torch.cuda.current_stream(self.dev).synchronize()
        if band is None:
            return out.numpy()
        return out.numpy(), down[n:2 * n].numpy()


def _pair(out):
    """A probe's (presence, band) bytes: (presence, None) without a band."""
    return out if isinstance(out, tuple) else (out, None)


class _Staging:
    """Kernel M's round trip for each batch of a repartition: the walk
    writes the keepers straight into a pinned host buffer, which goes up
    in one copy; the [T, m] counters come back into another pinned buffer.
    Both grow as batches do, as _Prober's."""

    def __init__(self, device):
        self.dev = device
        self.cuda = device.type == "cuda"
        self._up = self._down = None

    def upload(self, walk, threshold):
        """The keepers of the walk's traversals of at least `threshold`
        nodes, an int64 tensor on the device (its copy may still run)."""
        m = walk.n_keepers(threshold)
        if self._up is None or self._up.shape[0] < m:
            self._up = torch.empty(max(m, 1 << 16), dtype=torch.int64,
                                   pin_memory=self.cuda)
        up = self._up[:m]
        walk.keepers(threshold, out=up.numpy().view(np.uint64))
        return up.to(self.dev, non_blocking=True)

    def download(self, base):
        """The counters `base` (uint8 [T, m] on the device) in host
        memory (numpy), once their copy has ended."""
        size = base.numel()
        if self._down is None or self._down.shape[0] < size:
            self._down = torch.empty(max(size, 1 << 16), dtype=torch.uint8,
                                     pin_memory=self.cuda)
        down = self._down[:size].view(base.shape)
        down.copy_(base, non_blocking=True)
        if self.cuda:
            torch.cuda.current_stream(self.dev).synchronize()
        return down.numpy()


def find_all_tags_batch(graph, starts_f, starts_r, break_on_stop_tags=False,
                        stop_big_traversals=False, tag_arrays=None,
                        count_range=None):
    """Run find_all_tags from many start k-mers (f, r): a list of
    ascending u64 arrays, the tags each traversal found, equal to JAX's
    find_all_tags_batch under its native engine (and to sequential
    reference runs). The traversals go in batches, sized to KEEPER_BYTES
    (see above); the answer does not depend on them. Each pass of the
    C++ walk walks a breadth level of every traversal of a batch; kernel
    L (N on a Countgraph) probes all their expanded nodes' neighbours in
    one launch; the loop over levels runs in C++ (_Prober.run).
    tag_arrays: the graph's tags and stop tags as u64 arrays, where the
    caller has them. count_range=(lo, hi): the abundance-truncated walk
    (find_all_tags_truncate_on_abundance)."""
    from khmer_tpu_torch.ops.host import TagWalk

    tags, stops = tag_arrays or (_sorted_tags(graph.all_tags),
                                 _sorted_tags(graph.stop_tags))
    starts_f = np.asarray(starts_f, dtype=np.uint64)
    starts_r = np.asarray(starts_r, dtype=np.uint64)
    start_ok = None
    if count_range is not None:  # each start's count: kernel B, bigcount
        counts = graph.get_counts_for_hashes(np.minimum(starts_f, starts_r))
        start_ok = (counts >= count_range[0]) & (counts <= count_range[1])
    probe = _Prober(graph, count_range)
    out = []
    size = min(WALK_BATCH, FIRST_BATCH)
    try:
        while len(out) < len(starts_f):
            lo = len(out)
            walk = TagWalk(starts_f[lo:lo + size], starts_r[lo:lo + size],
                           graph.ksize(), tags, stops,
                           2 * graph._tag_density + 1, break_on_stop_tags,
                           stop_big_traversals,
                           None if start_ok is None
                           else start_ok[lo:lo + size])
            try:
                probe.run(walk)
                out += walk.tags()
                held = walk.keeper_bytes()
            finally:
                walk.close()
            size = min(WALK_BATCH,
                       max(1, walk.n * KEEPER_BYTES // max(held, 1)))
    finally:
        probe.close()
    return out


def find_all_tags(graph, f, r, break_on_stop_tags=False,
                  stop_big_traversals=False):
    """The tags one traversal from the k-mer (f, r) finds, as a set."""
    tags = find_all_tags_batch(graph, [int(f)], [int(r)],
                               break_on_stop_tags, stop_big_traversals)[0]
    return set(int(t) for t in tags)


def find_all_tags_truncate_on_abundance(graph, f, r, min_count, max_count,
                                        break_on_stop_tags=False,
                                        stop_big_traversals=False):
    """The tags one abundance-truncated traversal from the k-mer (f, r)
    finds (subset.cc:399-496), as a set."""
    tags = find_all_tags_batch(graph, [int(f)], [int(r)],
                               break_on_stop_tags, stop_big_traversals,
                               count_range=(min_count, max_count))[0]
    return set(int(t) for t in tags)


def sweep_for_tags_batch(graph, seqs, sweep_range=0, break_on_stop_tags=False,
                         stop_big_traversals=False):
    """The perimeter sweep of each sequence (sweep_for_tags) in one walk,
    a breadth level of every sweep a pass, each level's expanded nodes
    probed in one launch of kernel L (N on a Countgraph): (a list of
    ascending u64 arrays, the tags each sweep found; int64 [n], the nodes
    each counted), equal to JAX's sweep_for_tags under its native engine."""
    from khmer_tpu_torch.ops.host import SweepWalk

    k = graph.ksize()
    seeds_f, seeds_r, lens = [], [], [0]
    for seq in seqs:
        if len(seq) < k:
            lens.append(0)
            continue
        _, f, r = H.rolling_hash_windows(
            torch.from_numpy(H.encode_dna(seq)), k)
        seeds_f.append(f.numpy().view(np.uint64))
        seeds_r.append(r.numpy().view(np.uint64))
        lens.append(f.shape[0])
    if len(lens) == 1:
        return [], np.zeros(0, np.int64)
    walk = SweepWalk(
        np.concatenate(seeds_f) if seeds_f else np.zeros(0, np.uint64),
        np.concatenate(seeds_r) if seeds_r else np.zeros(0, np.uint64),
        np.cumsum(lens), k, _sorted_tags(graph.all_tags),
        _sorted_tags(graph.stop_tags), sweep_range, break_on_stop_tags,
        stop_big_traversals)
    probe = None
    try:
        probe = _Prober(graph)
        probe.run(walk)
        return walk.result()
    finally:
        walk.close()
        if probe is not None:
            probe.close()


def sweep_for_tags(graph, seq, sweep_range=0, break_on_stop_tags=False,
                   stop_big_traversals=False):
    """The tags within `sweep_range` of the sequence's k-mers
    (SubsetPartition::sweep_for_tags, subset.cc:305-394): (a set, the
    nodes counted), as JAX's sweep_for_tags gives them."""
    found, totals = sweep_for_tags_batch(graph, [seq], sweep_range,
                                         break_on_stop_tags,
                                         stop_big_traversals)
    return set(int(t) for t in found[0]), int(totals[0])


class SubsetPartition:
    """Union-find partition map over tags (reference subset.hh:59)."""

    def __init__(self, graph):
        self.graph = graph
        self.next_partition_id = 2  # reference: subset.cc:85
        self.partition_map = {}     # tag -> _Box or None
        self.reverse_pmap = {}      # pid -> set of _Box (id-keyed)

    # -- core union-find (mirrors subset.cc:630-788) ----------------------

    def assign_partition_id(self, kmer, tagged_kmers):
        if len(tagged_kmers):
            pp = self._join_partitions_by_tags(tagged_kmers, kmer)
            return pp.pid
        self.partition_map.pop(kmer, None)
        return 0

    def _join_partitions_by_tags(self, tagged_kmers, kmer):
        # iterate in sorted order: the reference's SeenSet is an
        # ordered std::set, and the first ASSIGNED tag found decides
        # which partition ID survives the joins (subset.cc:680-689)
        tagged_kmers = sorted(int(t) for t in tagged_kmers)
        this_pp = None
        for t in tagged_kmers:
            this_pp = self.partition_map.get(t)
            if this_pp is not None:
                break

        if this_pp is None:
            this_pp = _Box(self.next_partition_id)
            self.next_partition_id += 1
            self.reverse_pmap[this_pp.pid] = {this_pp}

        for t in tagged_kmers:
            if t not in self.partition_map:
                self.partition_map[t] = this_pp
            else:
                pp_id = self.partition_map[t]
                if pp_id is None:
                    self.partition_map[t] = this_pp
                elif pp_id.pid != this_pp.pid:
                    this_pp = self._merge_two_partitions(this_pp, pp_id)

        self.partition_map[kmer] = this_pp
        return this_pp

    def _merge_two_partitions(self, the_pp, merge_pp):
        s = self.reverse_pmap[the_pp.pid]
        t = self.reverse_pmap[merge_pp.pid]
        if len(s) < len(t):
            s, t = t, s
            the_pp, merge_pp = merge_pp, the_pp
        del self.reverse_pmap[merge_pp.pid]
        for box in t:
            box.pid = the_pp.pid
            s.add(box)
        return the_pp

    def get_partition_id(self, kmer):
        if isinstance(kmer, str):
            kmer = self.graph.hash(kmer)
        pp = self.partition_map.get(int(kmer))
        return pp.pid if pp is not None else 0

    def get_new_partition(self):
        pp = _Box(self.next_partition_id)
        self.next_partition_id += 1
        return pp

    def set_partition_id(self, kmer, pid):
        """Put a tag (k-mer or hash) in partition `pid`, the partition's
        box shared by its tags (subset.cc set_partition_id)."""
        if isinstance(kmer, str):
            kmer = self.graph.hash(kmer)
        s = self.reverse_pmap.get(pid)
        if s is None:
            pp = _Box(pid)
            self.reverse_pmap[pid] = {pp}
        else:
            pp = next(iter(s))
        self.partition_map[int(kmer)] = pp
        if self.next_partition_id <= pid:
            self.next_partition_id = pid + 1

    # -- partitioning -----------------------------------------------------

    def do_partition(self, first_kmer=0, last_kmer=0,
                     break_on_stop_tags=False, stop_big_traversals=False,
                     count_range=None):
        """Walk + merge over a sorted tag range (subset.cc:501-553): the
        tags from first_kmer (the first tag, if 0) up to last_kmer (the
        end, if 0); count_range=(lo, hi) truncates each walk on abundance.
        The joins run in sorted tag order, so the walk's batches change
        nothing."""
        tags = _sorted_tags(self.graph.all_tags)
        lo = _index(tags, first_kmer) if first_kmer else 0
        hi = _index(tags, last_kmer) if last_kmer else len(tags)
        span = tags[lo:hi]
        k = self.graph.ksize()
        arrays = (tags, _sorted_tags(self.graph.stop_tags))
        found = find_all_tags_batch(
            self.graph, span, revcomp_bits(span, k), break_on_stop_tags,
            stop_big_traversals, arrays, count_range)
        for tag, tagged in zip(span.tolist(), found):
            self.assign_partition_id(tag, tagged.tolist())

    def do_partition_with_abundance(self, first_kmer=0, last_kmer=0,
                                    min_count=0, max_count=0,
                                    break_on_stop_tags=False,
                                    stop_big_traversals=False):
        """Partition through the k-mers whose count lies in [min_count,
        max_count] alone (SubsetPartition::do_partition_with_abundance,
        subset.cc:557-613)."""
        self.do_partition(first_kmer, last_kmer, break_on_stop_tags,
                          stop_big_traversals,
                          count_range=(min_count, max_count))

    # -- reporting --------------------------------------------------------

    def count_partitions(self):
        """(n_partitions, n_unassigned) — subset.cc:89-113.

        Iterates the graph's tag set (not the map): tags never assigned
        count as unassigned. The reference's operator[] lookup inserts
        a NULL map entry for such tags as a side effect, which later
        partition_sizes calls then see; reproduced for parity.
        """
        partitions = set()
        n_unassigned = 0
        for tag in self.graph.all_tags:
            pp = self.partition_map.setdefault(int(tag), None)
            if pp is not None:
                partitions.add(pp.pid)
            else:
                n_unassigned += 1
        return len(partitions), n_unassigned

    def _sizes(self):
        counts = {}
        n_unassigned = 0
        for pp in self.partition_map.values():
            if pp is not None:
                counts[pp.pid] = counts.get(pp.pid, 0) + 1
            else:
                n_unassigned += 1
        return counts, n_unassigned

    def partition_sizes(self, min_size=0):
        counts, n_unassigned = self._sizes()
        return ([(pid, n) for pid, n in sorted(counts.items())
                 if n >= min_size], n_unassigned)

    def partition_size_distribution(self):
        counts, n_unassigned = self._sizes()
        dist = {}
        for n in counts.values():
            dist[n] = dist.get(n, 0) + 1
        return sorted(dist.items()), n_unassigned

    # -- merging ----------------------------------------------------------

    def merge(self, other):
        if self is other:
            return
        diskp_to_pp = {}
        for tag in sorted(other.partition_map):
            pp = other.partition_map[tag]
            if pp is not None:
                self._merge_other(tag, pp.pid, diskp_to_pp)

    def _merge_other(self, tag, other_partition, diskp_to_pp):
        """subset.cc:832-880."""
        if tag in self.graph.stop_tags:
            return
        pp_0 = self.partition_map.get(tag)
        if pp_0 is None:
            existing = diskp_to_pp.get(other_partition)
            if existing is not None:
                self.partition_map[tag] = existing
            else:
                pp_0 = self.get_new_partition()
                self.reverse_pmap[pp_0.pid] = {pp_0}
                self.partition_map[tag] = pp_0
                diskp_to_pp[other_partition] = pp_0
        else:
            existing = diskp_to_pp.get(other_partition)
            if existing is not None:
                if pp_0.pid != existing.pid:
                    pp_0 = self._merge_two_partitions(pp_0, existing)
                    diskp_to_pp[other_partition] = pp_0
            else:
                diskp_to_pp[other_partition] = pp_0

    def merge_from_disk(self, filename):
        """Fold a saved .pmap file into this partition
        (subset.cc:884-1034)."""
        from khmer_tpu_torch.core.oxli_io import (SAVED_FORMAT_VERSION,
                                                  SAVED_SIGNATURE,
                                                  SAVED_SUBSET, _open_read)

        with _open_read(filename) as f:
            sig = f.read(4)
            if sig != SAVED_SIGNATURE:
                raise OSError(
                    "Incorrect file signature 0x%s while reading subset "
                    "pmap from %s; should be OXLI" % (sig.hex(), filename))
            version = f.read(1)[0]
            if version != SAVED_FORMAT_VERSION:
                raise OSError(
                    "Incorrect file format version %d while reading "
                    "subset pmap from %s" % (version, filename))
            ht_type = f.read(1)[0]
            if ht_type != SAVED_SUBSET:
                raise OSError(
                    "Incorrect file format type %d while reading subset "
                    "pmap from %s" % (ht_type, filename))
            (ksize,) = struct.unpack("<I", f.read(4))
            if ksize != self.graph.ksize():
                raise OSError(
                    "Incorrect k-mer size %d while reading subset pmap "
                    "from %s" % (ksize, filename))
            f.read(8)  # pmap_size header (includes null entries)
            data = f.read()
        n = len(data) // 12
        rec = np.frombuffer(data[:12 * n], dtype=[("tag", "<u8"),
                                                  ("pid", "<u4")])
        diskp_to_pp = {}
        for tag, pid in zip(rec["tag"].tolist(), rec["pid"].tolist()):
            self._merge_other(tag, pid, diskp_to_pp)

    def save_partitionmap(self, filename):
        """subset.cc:1036-1097 (tags in sorted order)."""
        from khmer_tpu_torch.core.oxli_io import (SAVED_FORMAT_VERSION,
                                                  SAVED_SIGNATURE,
                                                  SAVED_SUBSET)

        tags = sorted(t for t, pp in self.partition_map.items()
                      if pp is not None)
        rec = np.empty(len(tags), dtype=[("tag", "<u8"), ("pid", "<u4")])
        rec["tag"] = tags
        rec["pid"] = [self.partition_map[t].pid for t in tags]
        with open(filename, "wb") as f:
            f.write(SAVED_SIGNATURE)
            f.write(bytes([SAVED_FORMAT_VERSION, SAVED_SUBSET]))
            f.write(struct.pack("<IQ", self.graph.ksize(),
                                len(self.partition_map)))
            f.write(rec.tobytes())

    def load_partitionmap(self, filename):
        self.merge_from_disk(filename)

    @classmethod
    def load(cls, filename, graph):
        subset = cls(graph)
        subset.merge_from_disk(filename)
        return subset

    # -- knot detection ---------------------------------------------------

    def _clear_partition(self, the_partition):
        """Remove a partition; returns its tags (subset.cc:1398-1424)."""
        partition_tags = set()
        for tag, pp in self.partition_map.items():
            if pp is not None and pp.pid == the_partition:
                partition_tags.add(tag)
        for tag in partition_tags:
            del self.partition_map[tag]
        self.reverse_pmap.pop(the_partition, None)
        return partition_tags

    def repartition_largest_partition(self, distance, threshold,
                                      frequency, counting):
        """Find the highly connected k-mers of the largest partition and
        make them stop tags, then partition its tags again
        (subset.cc:1218-1359; see above). `counting` (a Countgraph or a
        SmallCountgraph) counts
        the k-mers of every excursion of at least `threshold` nodes, within
        `distance` of its tag; a k-mer counted more than `frequency` times
        becomes a stop tag. Returns the size of the next-largest
        partition."""
        from khmer_tpu_torch.core import sketch_kernels as K
        from khmer_tpu_torch.core.traversal import walk_excursions

        cm = {}
        for tag, pp in self.partition_map.items():
            if pp is not None:
                cm[pp.pid] = cm.get(pp.pid, 0) + 1
        if not cm:
            raise RuntimeError("no partitions to repartition")
        biggest_size = max(cm.values())
        biggest_p = 0
        for pid, size in cm.items():
            if size == biggest_size:
                biggest_p = pid
        sizes = sorted(set(cm.values()))
        next_largest = sizes[-2] if len(sizes) > 1 else 0

        bigtags = self._clear_partition(biggest_p)
        graph = self.graph
        k = graph.ksize()
        todo = _sorted_tags([t for t in bigtags
                             if t not in graph.repart_small_tags])
        staging = _Staging(counting.device)
        # the most a counter holds: the evaluation saturates the batch's
        # earlier adds there, as the table does
        saturation = (K.NIBBLE_MAX if counting.storage_kind == "nibble"
                      else K.MAX_KCOUNT)
        size = min(REPART_BATCH, REPART_FIRST)
        at = 0
        while at < len(todo):
            batch = todo[at:at + size]
            walk = walk_excursions(graph, batch, revcomp_bits(batch, k),
                                   distance)
            try:
                base = K.pertable_counts(
                    counting.storage_kind, counting._primes,
                    counting.tables, staging.upload(walk, threshold))
                stops, adds, small, _ = walk.evaluate(
                    staging.download(base), counting._primes, threshold,
                    frequency, saturation)
                held = walk.keeper_bytes()
            finally:
                walk.close()
            graph.stop_tags.update(stops.tolist())
            graph.repart_small_tags.update(batch[small].tolist())
            if len(adds):
                counting._commit_hashes(adds)
            at += len(batch)
            size = min(REPART_BATCH,
                       max(1, len(batch) * KEEPER_BYTES // max(held, 1)))

        self.repartition_a_partition(bigtags)
        return next_largest

    def repartition_a_partition(self, partition_tags):
        """Partition a tag set again, each walk breaking on stop tags
        (subset.cc:1361-1392): each tag joins the tags of the set that
        its walk finds, in sorted tag order."""
        tags = _sorted_tags(partition_tags)
        k = self.graph.ksize()
        found = find_all_tags_batch(self.graph, tags, revcomp_bits(tags, k),
                                    break_on_stop_tags=True,
                                    stop_big_traversals=False)
        for tag, tagged in zip(tags.tolist(), found):
            at = np.searchsorted(tags, tagged)
            inside = at < len(tags)
            inside[inside] = tags[at[inside]] == tagged[inside]
            self.assign_partition_id(tag, tagged[inside].tolist())

    # -- annotation -------------------------------------------------------

    def output_partitioned_file(self, infilename, outputfile,
                                output_unassigned=False):
        """Annotate reads with partition IDs (subset.cc:115-208), as
        JAX's host tier does (partition.py:846-904): the reads come in
        windows of records, the dense hasher hashes a window in one C
        call, and each read's first k-mer that is a tag of the map (a
        C++ set lookup) gives its partition. Returns the partitions seen
        plus the reads whose first mapped tag has none."""
        from khmer_tpu_torch.core import hostengine, pipeline
        from khmer_tpu_torch.ops.host import U64Set

        n_singletons = 0
        partitions = set()
        k = self.graph.ksize()
        pmap = self.partition_map
        tags = U64Set(_sorted_tags(pmap))
        try:
            with open(outputfile, "w") as outfile:
                for window in _windows(pipeline.records_from(infilename)):
                    seqs = [read.cleaned_seq for read in window]
                    lens = np.fromiter(map(len, seqs), np.int64, len(seqs))
                    flat = hostengine.hash_dense_reads(
                        H.encode_dna("".join(seqs)), np.cumsum(lens) - lens,
                        lens, k, "twobit")
                    first = tags.first_members(
                        flat, np.maximum(lens - k + 1, 0)).tolist()
                    lines = []
                    for read, seq, at in zip(window, seqs, first):
                        partition_id = 0
                        if at >= 0:
                            pp = pmap[int(flat[at])]
                            if pp is None:
                                n_singletons += 1
                            else:
                                partition_id = pp.pid
                                partitions.add(partition_id)
                        if partition_id > 0 or output_unassigned:
                            if read.quality:
                                lines.append("@%s\t%d\n%s\n+\n%s\n" % (
                                    read.name, partition_id, seq,
                                    read.quality))
                            else:
                                lines.append(">%s\t%d\n%s\n" % (
                                    read.name, partition_id, seq))
                    outfile.write("".join(lines))
        finally:
            tags.close()
        return len(partitions) + n_singletons


def _windows(records, size=16384):
    """Lists of at most `size` records, in order."""
    batch = []
    for rec in records:
        batch.append(rec)
        if len(batch) >= size:
            yield batch
            batch = []
    if batch:
        yield batch


_ATOI = re.compile(r"^\s*[+-]?\d+")


def _atoi_prefix(s):
    """C atoi(): the leading integer of s, 0 if it has none, so '35 foo'
    and '35abc' give 35 (the reference's partition id parse,
    include/oxli/read_parsers.hh:210-233)."""
    m = _ATOI.match(s)
    return int(m.group(0)) if m else 0


def consume_partitioned_fasta(graph, filename):
    """Load a partition-annotated FASTA (reference hashgraph.cc:368-418):
    each read's name ends in a tab and its partition id; its first k-mer
    becomes a tag in that partition. Then every read is counted through
    the sketch's consume (kernel A on a Countgraph, J on a Nodegraph).
    Returns (total reads, new k-mers, the SubsetPartition). A name with no
    tab raises ValueError."""
    from khmer_tpu_torch.core import pipeline

    subset = SubsetPartition(graph)
    k = graph.ksize()
    total_reads = 0
    if isinstance(filename, str):
        records, second_pass = pipeline.records_from(filename), filename
    else:
        records = list(pipeline.records_from(filename))
        second_pass = records
    for record in records:
        seq = record.cleaned_seq
        parts = record.name.rsplit("\t", 1)
        if len(parts) != 2:
            raise ValueError("consume_partitioned_fasta cannot find "
                             "partition ID for read " + record.name)
        pid = _atoi_prefix(parts[1])
        total_reads += 1
        if len(seq) < k:
            continue
        tag = graph.hash(seq[:k])
        graph.all_tags.add(tag)
        subset.set_partition_id(tag, pid)
    _, n_consumed = pipeline.consume_seqfile(graph, second_pass)
    return total_reads, n_consumed, subset
