"""Bounded-radius traversal of the implicit de Bruijn graph —
counterpart of khmer_tpu/core/traversal.py (bfs :39, traverse_from_kmer
:120; reference src/oxli/hashgraph.cc:503-570).

A traversal pops a FIFO queue from one k-mer: it stops once an entry's
breadth exceeds the radius (or, with max_count, once more than max_count
nodes are kept), skips a node already kept or a stop tag, keeps any
other, and queues its present neighbours. Without max_count it keeps
every node within the radius that can be reached without passing a stop
tag, so a walk a breadth level at a time keeps the same nodes; a level
keeps its new nodes in the queue's order, so max_count cuts it where the
queue would.

walk_excursions runs a batch of traversals that way: the host's C++
(csrc/excursion_walk.cc, ops/host.py ExcursionWalk) walks a level of
every traversal a pass and kernel L (csrc/neighbors.cu; N on a
Countgraph, N's nibble mode on a SmallCountgraph) probes the neighbours
of all the nodes it kept at once, as the partition walk does
(core/partition.py). bfs, the queue one node at a time in Python with
each neighbour's count read from the tables one by one
(partition.plain_count), is its plain reference, which only the tests
run.
"""

from collections import deque

import numpy as np

from khmer_tpu_torch.ops import hashing as H


def _start(graph, kmer):
    """(f, r) of a k-mer string or canonical hash."""
    if isinstance(kmer, str):
        _, f, r = H._hash_scalar(kmer, graph.ksize())
    else:
        s = H.reverse_hash(int(kmer), graph.ksize())
        _, f, r = H._hash_scalar(s, graph.ksize())
    return int(f), int(r)


def bfs(graph, start_f, start_r, radius, max_count=0):
    """The plain reference: the FIFO traversal of radius `radius` from
    (start_f, start_r), one node at a time (JAX bfs, the native engine's
    traverse_from_kmer), skipping the graph's stop tags. Returns (count,
    keeper), keeper the set of kept canonical k-mers."""
    from khmer_tpu_torch.core.partition import plain_count

    keeper = set()
    stop_tags = graph.stop_tags
    k = graph.ksize()
    mask = (1 << (2 * k)) - 1
    shift = 2 * k - 2
    present = plain_count(graph)
    count = 0
    queue = deque([(int(start_f), int(start_r), 0)])
    while queue:
        f, r, breadth = queue.popleft()
        if breadth > radius:
            break
        if max_count and count > max_count:
            break
        c = min(f, r)
        if c in keeper or c in stop_tags:
            continue
        keeper.add(c)
        count += 1
        for side in range(2):
            for b in (0, 2, 3, 1):  # A, C, G, T
                if side == 0:
                    nf = ((f << 2) | b) & mask
                    nr = (r >> 2) | ((b ^ 1) << shift)
                else:
                    nf = (f >> 2) | (b << shift)
                    nr = ((r << 2) | (b ^ 1)) & mask
                nc = min(nf, nr)
                if present(nc) and nc not in keeper:
                    queue.append((nf, nr, breadth + 1))
    return count, keeper


def walk_excursions(graph, starts_f, starts_r, radius, max_count=0):
    """The traversals of radius `radius` from the k-mers (f, r), skipping
    the graph's stop tags, a breadth level of all of them a pass, each
    level's nodes probed in one launch (partition._Prober): an
    ExcursionWalk that has ended (its counts(), keepers(), evaluate());
    the caller closes it."""
    from khmer_tpu_torch.core.partition import _Prober, _sorted_tags
    from khmer_tpu_torch.ops.host import ExcursionWalk

    walk = ExcursionWalk(starts_f, starts_r, graph.ksize(),
                         _sorted_tags(graph.stop_tags), radius, max_count)
    probe = None
    try:
        probe = _Prober(graph)
        n = walk.step()
        while n:
            n = walk.step(probe(walk, n))
    except BaseException:
        walk.close()
        raise
    finally:
        if probe is not None:
            probe.close()
    return walk


def traverse_from_kmer(graph, kmer, radius, max_count=0, keeper=None):
    """The number of nodes the traversal of radius `radius` from `kmer` (a
    string or a canonical hash) keeps, skipping the graph's stop tags
    (reference Hashgraph::traverse_from_kmer); the kept canonical k-mers
    are added to `keeper` where it is given."""
    f, r = _start(graph, kmer)
    walk = walk_excursions(graph, [f], [r], radius, max_count)
    try:
        found = walk.keepers()
    finally:
        walk.close()
    if keeper is not None:
        keeper.update(int(c) for c in found)
    return len(found)
