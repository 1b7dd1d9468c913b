#!/usr/bin/env python
"""Find an initial set of highly connected k-mers (knots).

Counterpart of khmer_tpu/cli/make_initial_stoptags.py (the reference
scripts/make-initial-stoptags.py): the nodegraph is loaded onto the
device, the first tag range is partitioned as partition-graph does, and
the largest partition is repartitioned with an excursion countgraph on
the same device (core/partition.py repartition_largest_partition: the
excursions walked a level at a time with kernel L's probe, counted with
kernel M's gather and kernel A's update); the same flags and outputs,
plus --device.

% python -m khmer_tpu_torch.cli.make_initial_stoptags <graphbase>
"""

import sys
import textwrap

from khmer_tpu_torch import load_nodegraph
from khmer_tpu_torch.cli import args as khmer_args
from khmer_tpu_torch.cli.args import build_counting_args, sanitize_help
from khmer_tpu_torch.utils.kfile import check_input_files

DEFAULT_SUBSET_SIZE = int(1e4)
DEFAULT_COUNTING_HT_SIZE = 3e6
DEFAULT_COUNTING_HT_N = 4

# don't change these!  (reference: scripts/make-initial-stoptags.py:66-68)
EXCURSION_DISTANCE = 40
EXCURSION_KMER_THRESHOLD = 200
EXCURSION_KMER_COUNT_THRESHOLD = 5


def get_parser():
    epilog = """\
    Loads a k-mer nodegraph/tagset pair created by
    :program:`load-graph.py`, and does a small set of traversals from
    graph waypoints; on these traversals, looks for k-mers that are
    repeatedly traversed in high-density regions of the graph, i.e. are
    highly connected. Outputs those k-mers as an initial set of
    stoptags, which can be fed into :program:`partition-graph.py`,
    :program:`find-knots.py`, and :program:`filter-stoptags.py`.
    """
    parser = build_counting_args(
        descr="Find an initial set of highly connected k-mers.",
        epilog=textwrap.dedent(epilog), citations=['graph'])
    parser.add_argument('-s', '--subset-size', default=DEFAULT_SUBSET_SIZE,
                        dest='subset_size', type=float,
                        help='Set subset size (default 1e4 is prob ok)')
    parser.add_argument('-S', '--stoptags', metavar='filename',
                        default='',
                        help="Use stoptags in this file during "
                        "partitioning")
    parser.add_argument('graphbase', help='basename for input and output '
                        'filenames')
    parser.add_argument('-f', '--force', default=False,
                        action='store_true',
                        help='Overwrite output file if it exists')
    parser.add_argument('--device', default='cuda',
                        help="PyTorch device that holds the nodegraph and "
                        "the countgraph, e.g. 'cuda', 'cuda:1' or 'cpu'.")
    return parser


def _load_graph_with_tags(graphbase, stoptags_file, device):
    """Load the nodegraph plus its tagset (and optional stoptags)."""
    print('loading nodegraph %s.pt' % graphbase, file=sys.stderr)
    nodegraph = load_nodegraph(graphbase, device=device)
    if stoptags_file:
        print('loading stoptags from', stoptags_file, file=sys.stderr)
        nodegraph.load_stop_tags(stoptags_file)
    print('loading tagset %s.tagset...' % graphbase, file=sys.stderr)
    nodegraph.load_tagset(graphbase + '.tagset')
    return nodegraph


def _first_tag_range(nodegraph, subset_size):
    """The first tag-range work unit of the partition decomposition
    (whole graph when the tagset fits one subset)."""
    divvy = list(nodegraph.divide_tags_into_subsets(subset_size))
    return (0, 0) if len(divvy) < 2 else (divvy[0], divvy[1])


def find_initial_stoptags(nodegraph, counting, subset_size):
    """Partition the first tag range, then repartition its largest
    partition with an excursion countgraph to flag highly-connected
    k-mers as stoptags (reference scripts/make-initial-stoptags.py)."""
    start, end = _first_tag_range(nodegraph, subset_size)
    print('doing pre-partitioning from', start, 'to', end,
          file=sys.stderr)
    subset = nodegraph.do_subset_partition(start, end)
    print('repartitioning to find HCKs.', file=sys.stderr)
    nodegraph.repartition_largest_partition(
        counting, EXCURSION_DISTANCE, EXCURSION_KMER_THRESHOLD,
        EXCURSION_KMER_COUNT_THRESHOLD, subs=subset)


def main(argv=None):
    args = sanitize_help(get_parser()).parse_args(argv)
    graphbase = args.graphbase

    infiles = [graphbase, graphbase + '.tagset']
    if args.stoptags:
        infiles.append(args.stoptags)
    for name in infiles:
        check_input_files(name, args.force)

    nodegraph = _load_graph_with_tags(graphbase, args.stoptags, args.device)
    counting = khmer_args.create_countgraph(args, device=args.device)
    find_initial_stoptags(nodegraph, counting, int(args.subset_size))

    print('saving stop tags', file=sys.stderr)
    nodegraph.save_stop_tags(graphbase + '.stoptags')
    print('wrote to:', graphbase + '.stoptags', file=sys.stderr)


if __name__ == '__main__':
    main()
