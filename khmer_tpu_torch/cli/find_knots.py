#!/usr/bin/env python
"""Find all highly connected k-mers (knots).

Counterpart of khmer_tpu/cli/find_knots.py (the reference
scripts/find-knots.py): for each subset .pmap, its largest partition is
repartitioned with an excursion countgraph (core/partition.py
repartition_largest_partition, on kernels L, M and A), merged into the
graph's partition and repartitioned again; the stop tags are saved after
each. The same flags and outputs, plus --device.

% python -m khmer_tpu_torch.cli.find_knots <base>
"""

import glob
import os
import sys
import textwrap

from khmer_tpu_torch import load_nodegraph
from khmer_tpu_torch.cli import args as khmer_args
from khmer_tpu_torch.cli.args import build_counting_args, sanitize_help
from khmer_tpu_torch.core.partition import SubsetPartition
from khmer_tpu_torch.utils.kfile import check_input_files, check_space

# counting hash parameters.
DEFAULT_COUNTING_HT_SIZE = 3e6
DEFAULT_COUNTING_HT_N = 4

# Lump removal parameters (reference scripts/find-knots.py): walk
# EXCURSION_DISTANCE out from each tag; an excursion of at least
# EXCURSION_KMER_THRESHOLD k-mers is "big", and each of its k-mers is
# counted; a k-mer counted more than EXCURSION_KMER_COUNT_THRESHOLD times
# becomes a stop tag.
EXCURSION_DISTANCE = 40
EXCURSION_KMER_THRESHOLD = 200
EXCURSION_KMER_COUNT_THRESHOLD = 5


def get_parser():
    epilog = """\
    Load an k-mer nodegraph/tagset pair created by load-graph.py, and a
    set of pmap files created by partition-graph.py. Go through each
    pmap file, select the largest partition in each, and do the
    same kind of traversal as in :program:`make-initial-stoptags.py`
    from each of the waypoints in that partition; this should identify
    all of the Highly Connected Kmers in that partition. These HCKs
    are output to <graphbase>.stoptags after each pmap file.
    """
    parser = build_counting_args(
        descr="Find all highly connected k-mers.",
        epilog=textwrap.dedent(epilog), citations=['graph'])
    parser.add_argument('graphbase', help='Basename for the input and '
                        'output files.')
    parser.add_argument('-f', '--force', default=False,
                        action='store_true',
                        help='Continue past warnings')
    parser.add_argument('--device', default='cuda',
                        help="PyTorch device that holds the nodegraph and "
                        "the countgraph, e.g. 'cuda', 'cuda:1' or 'cpu'.")
    return parser


def main(argv=None):  # pylint: disable=too-many-locals
    args = sanitize_help(get_parser()).parse_args(argv)

    graphbase = args.graphbase

    infiles = [graphbase, graphbase + '.tagset']
    if os.path.exists(graphbase + '.stoptags'):
        infiles.append(graphbase + '.stoptags')
    for _ in infiles:
        check_input_files(_, args.force)

    check_space(infiles, args.force)

    print('loading k-mer nodegraph %s' % graphbase, file=sys.stderr)
    graph = load_nodegraph(graphbase, device=args.device)

    print('loading tagset %s.tagset...' % graphbase, file=sys.stderr)
    graph.load_tagset(graphbase + '.tagset')

    initial_stoptags = False
    if os.path.exists(graphbase + '.stoptags'):
        print('loading stoptags %s.stoptags' % graphbase,
              file=sys.stderr)
        graph.load_stop_tags(graphbase + '.stoptags')
        initial_stoptags = True

    pmap_files = glob.glob(args.graphbase + '.subset.*.pmap')

    print('loading %d pmap files (first one: %s)' %
          (len(pmap_files), pmap_files[0]), file=sys.stderr)
    print('---', file=sys.stderr)
    print('output stoptags will be in',
          graphbase + '.stoptags', file=sys.stderr)
    if initial_stoptags:
        print('(these output stoptags will include the already-loaded '
              'set)', file=sys.stderr)
    print('---', file=sys.stderr)

    # create countgraph
    ksize = graph.ksize()
    counting = khmer_args.create_countgraph(args, ksize=ksize,
                                            device=args.device)

    # load & merge
    for index, subset_file in enumerate(pmap_files):
        print('<-', subset_file, file=sys.stderr)
        subset = SubsetPartition.load(subset_file, graph)

        print('** repartitioning subset... %s' % subset_file,
              file=sys.stderr)
        graph.repartition_largest_partition(
            counting, EXCURSION_DISTANCE, EXCURSION_KMER_THRESHOLD,
            EXCURSION_KMER_COUNT_THRESHOLD, subs=subset)

        print('** merging subset... %s' % subset_file, file=sys.stderr)
        graph.merge_subset(subset)

        print('** repartitioning, round 2... %s' % subset_file,
              file=sys.stderr)
        size = graph.repartition_largest_partition(
            counting, EXCURSION_DISTANCE, EXCURSION_KMER_THRESHOLD,
            EXCURSION_KMER_COUNT_THRESHOLD)

        print('** repartitioned size:', size, file=sys.stderr)

        print('saving stoptags binary', file=sys.stderr)
        graph.save_stop_tags(graphbase + '.stoptags')
        os.rename(subset_file, subset_file + '.processed')
        print('(%d of %d)\n' % (index, len(pmap_files)),
              file=sys.stderr)

    print('done!', file=sys.stderr)


if __name__ == '__main__':
    main()
