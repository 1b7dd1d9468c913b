#!/usr/bin/env python
"""Partition a saved graph by tag-range subsets, writing .pmap files.

Counterpart of khmer_tpu/cli/partition_graph.py (the reference
scripts/partition-graph.py): the nodegraph is loaded onto the device,
each subset's walk runs a level at a time on the host with kernel L's
neighbour probe on the card; the same flags and outputs, plus --device.
--threads is accepted and ignored, as in JAX.

% python -m khmer_tpu_torch.cli.partition_graph <base>
"""

import os
import sys
import textwrap

from khmer_tpu_torch import load_nodegraph
from khmer_tpu_torch.cli.args import (KhmerArgumentParser, add_threading_args,
                                sanitize_help)
from khmer_tpu_torch.utils.kfile import check_input_files

DEFAULT_SUBSET_SIZE = int(1e5)


def get_parser():
    epilog = """\
    The resulting partition maps are saved as ``${basename}.subset.#.pmap``
    files.
    """
    parser = KhmerArgumentParser(
        description="Partition a sequence graph based upon waypoint "
        "connectivity", epilog=textwrap.dedent(epilog),
        citations=['graph'])

    parser.add_argument('basename', help="basename of the input k-mer "
                        "nodegraph + tagset files")
    parser.add_argument('--stoptags', '-S', metavar='filename',
                        default='',
                        help="Use stoptags in this file during "
                        "partitioning")
    parser.add_argument('--subset-size', '-s', default=DEFAULT_SUBSET_SIZE,
                        dest='subset_size', type=float,
                        help='Set subset size (usually 1e5-1e6 is good)')
    parser.add_argument('--no-big-traverse', action='store_true',
                        default=False,
                        help='Truncate graph joins at big traversals')
    add_threading_args(parser)
    parser.add_argument('-f', '--force', default=False,
                        action='store_true')
    parser.add_argument('--device', default='cuda',
                        help="PyTorch device that holds the nodegraph, "
                        "e.g. 'cuda', 'cuda:1' or 'cpu'.")
    return parser


def main(argv=None):
    args = sanitize_help(get_parser()).parse_args(argv)
    basename = args.basename

    filenames = [basename, basename + '.tagset']
    for _ in filenames:
        check_input_files(_, args.force)

    print('--', file=sys.stderr)
    print('SUBSET SIZE', args.subset_size, file=sys.stderr)
    print('N THREADS', args.threads, file=sys.stderr)
    if args.stoptags:
        print('stoptag file:', args.stoptags, file=sys.stderr)
    print('--', file=sys.stderr)

    print('loading nodegraph %s' % basename, file=sys.stderr)
    nodegraph = load_nodegraph(basename, device=args.device)
    nodegraph.load_tagset(basename + '.tagset')

    # do we want to load stop tags, and do they exist?
    if args.stoptags:
        print('loading stoptags from', args.stoptags, file=sys.stderr)
        nodegraph.load_stop_tags(args.stoptags)

    # do we want to exhaustively traverse the graph?
    stop_big_traversals = args.no_big_traverse
    if stop_big_traversals:
        print('** This script brakes for lumps:',
              ' stop_big_traversals is true.', file=sys.stderr)
    else:
        print('** Traverse all the things:',
              ' stop_big_traversals is false.', file=sys.stderr)

    # divide the tags up into subsets
    divvy = nodegraph.divide_tags_into_subsets(int(args.subset_size))
    divvy = list(divvy)
    n_subsets = len(divvy)
    divvy.append(0)

    print('enqueued %d subset tasks' % n_subsets, file=sys.stderr)
    open('%s.info' % basename, 'w').write('%d subsets total\n'
                                          % (n_subsets))

    for index in range(n_subsets):
        start = divvy[index]
        end = divvy[index + 1]
        outfile = basename + '.subset.%d.pmap' % (index,)
        if os.path.exists(outfile):
            print('SKIPPING', outfile, ' -- already exists',
                  file=sys.stderr)
            continue
        print('starting:', basename, index, file=sys.stderr)
        subset = nodegraph.do_subset_partition(start, end, True,
                                               stop_big_traversals)
        print('saving:', basename, index, file=sys.stderr)
        subset.save_partitionmap(outfile)

    print('done making subsets! see %s.subset.*.pmap' %
          (basename,), file=sys.stderr)


if __name__ == '__main__':
    main()
