"""khmer_tpu_torch — the PyTorch + CUDA port of khmer_tpu.

The JAX package ``khmer_tpu`` is the reference; this package computes
the same tables, counts and files with PyTorch, and runs the hot
kernels as hand-written CUDA for Hopper (csrc/). It imports no JAX.
Ported so far: the counting path in the exact byte layout (Countgraph,
bigcount, OXLI type-1 files, the default of load-into-counting), in the
nibble layout (SmallCountgraph, OXLI type 7, --small-count) and in
the blocked layout, the abundance histogram (abundance-dist,
abundance-dist-single), digital normalization (normalize-by-median),
trimming (trim-low-abund, filter-abund, filter-abund-single), the
HyperLogLog counter (unique-kmers), the Nodegraph with its tags
(load-graph), the partitioning of its tag graph (do-partition,
partition-graph, merge-partitions, annotate-partitions, extract-partitions)
and the knot pipeline (make-initial-stoptags, find-knots,
filter-stoptags); the Countgraph's graph half (tagging, neighbours,
partitioning with and without an abundance band, the perimeter sweep,
consume_partitioned_fasta), its sequence API and count-median; the
SmallCountgraph's graph half; the murmur and cyclic tables (Counttable,
SmallCounttable, Nodetable, BlockedCounttable, CyclicCounttable), and the
masked and banded consumes of every sketch. Sketches are made on the card ("cuda") unless the caller names another
device.
"""

__version__ = "0.1.0"

# Memory-per-bucket ratios per graph type (reference: khmer/__init__.py:86-92)
_buckets_per_byte = {
    # calculated by hand from settings in third-party/cqf/gqf.h
    "qfcounttable": 1 / 1.26,
    "countgraph": 1,
    "smallcountgraph": 2,
    "nodegraph": 8,
}

from khmer_tpu_torch.core.blocked import (  # noqa: E402
    BlockedCountgraph,
    BlockedCounttable,
)
from khmer_tpu_torch.core.hll import HLLCounter  # noqa: E402
from khmer_tpu_torch.core.oxli_io import (  # noqa: E402
    load_countgraph,
    load_counttable,
    load_nodegraph,
    load_nodetable,
)
from khmer_tpu_torch.core.sketch import (  # noqa: E402
    Countgraph,
    Counttable,
    CyclicCounttable,
    Nodegraph,
    Nodetable,
    SmallCountgraph,
    SmallCounttable,
)


def calc_expected_collisions(graph, force=False, max_false_pos=0.2):
    """FP-rate guard mirroring reference khmer/__init__.py:181-215."""
    import sys

    sizes = graph.hashsizes()
    n_ht = float(len(sizes))
    occupancy = float(graph.n_occupied())
    min_size = min(sizes)

    fp_one = occupancy / float(min_size)
    fp_all = fp_one ** n_ht

    if fp_all > max_false_pos:
        print("**", file=sys.stderr)
        print(
            "** ERROR: the graph structure is too small for this data set."
            "Increase data structure size with --max_memory_usage/-M.",
            file=sys.stderr,
        )
        print("** Do not use these results!!", file=sys.stderr)
        print("**", file=sys.stderr)
        print("** (estimated false positive rate of %.3f;" % fp_all,
              file=sys.stderr, end=' ')
        print("max recommended %.3f)" % max_false_pos, file=sys.stderr)
        print("**", file=sys.stderr)

        if not force:
            sys.exit(1)

    return fp_all


__all__ = [
    "BlockedCountgraph",
    "BlockedCounttable",
    "Countgraph",
    "Counttable",
    "CyclicCounttable",
    "HLLCounter",
    "Nodegraph",
    "Nodetable",
    "SmallCountgraph",
    "SmallCounttable",
    "calc_expected_collisions",
    "load_countgraph",
    "load_counttable",
    "load_nodegraph",
    "load_nodetable",
]
