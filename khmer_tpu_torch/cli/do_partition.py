#!/usr/bin/env python
"""Load, partition, and annotate sequences in one go.

Counterpart of khmer_tpu/cli/do_partition.py (the reference
scripts/do-partition.py): build the nodegraph and its tagset (kernel J
on the card, the tag spacing on the host), partition the tag graph in
subsets (the level walk on the host, kernel L's neighbour probe on the
card), merge the partition maps in the order glob gives their files, and
annotate the reads with partition IDs: the same flags, outputs and
messages, plus --device. --threads is accepted and ignored, as in JAX.

% python -m khmer_tpu_torch.cli.do_partition <graphbase> <data1> [ <data2> <...> ]
"""

import glob
import os
import sys
import textwrap

from khmer_tpu_torch import Nodegraph, calc_expected_collisions
from khmer_tpu_torch.cli import args as khmer_args
from khmer_tpu_torch.cli.args import (add_threading_args, build_nodegraph_args,
                                report_on_config, sanitize_help)
from khmer_tpu_torch.utils.kfile import check_input_files, check_space

DEFAULT_SUBSET_SIZE = int(1e5)


def get_parser():
    epilog = """\
    Load in a set of sequences, partition them, merge the partitions,
    and annotate the original sequences files with the partition
    information.

    This script combines the functionality of
    :program:`load-graph.py`, :program:`partition-graph.py`,
    :program:`merge-partitions.py`, and
    :program:`annotate-partitions.py` into one script. This is
    convenient but should probably not be used for large data sets,
    because :program:`do-partition.py` doesn't provide save/resume
    functionality.
    """
    parser = build_nodegraph_args(
        descr='Load, partition, and annotate FAST[AQ] sequences',
        epilog=textwrap.dedent(epilog), citations=['graph'])
    add_threading_args(parser)
    parser.add_argument('--subset-size', '-s', default=DEFAULT_SUBSET_SIZE,
                        dest='subset_size', type=float,
                        help='Set subset size (usually 1e5-1e6 is good)')
    parser.add_argument('--no-big-traverse', dest='no_big_traverse',
                        action='store_true', default=False,
                        help='Truncate graph joins at big traversals')
    parser.add_argument('--keep-subsets', dest='remove_subsets',
                        default=True, action='store_false',
                        help='Keep individual subsets')
    parser.add_argument('graphbase', help="base name for output files")
    parser.add_argument('input_filenames', metavar='input_sequence_filename',
                        nargs='+', help='input FAST[AQ] sequence filenames')
    parser.add_argument('-f', '--force', default=False,
                        action='store_true',
                        help='Overwrite output file if it exists')
    parser.add_argument('--device', default='cuda',
                        help="PyTorch device that holds the nodegraph, "
                        "e.g. 'cuda', 'cuda:1' or 'cpu'.")
    return parser


def main(argv=None):  # pylint: disable=too-many-locals,too-many-statements
    args = sanitize_help(get_parser()).parse_args(argv)

    report_on_config(args, graphtype='nodegraph')

    for infile in args.input_filenames:
        check_input_files(infile, args.force)

    check_space(args.input_filenames, args.force)

    print('Saving k-mer nodegraph to %s' %
          args.graphbase, file=sys.stderr)
    print('Loading kmers from sequences in %s' %
          repr(args.input_filenames), file=sys.stderr)
    print('--', file=sys.stderr)
    print('SUBSET SIZE', args.subset_size, file=sys.stderr)
    print('N THREADS', args.threads, file=sys.stderr)
    print('--', file=sys.stderr)

    # load-graph.py
    print('making nodegraph', file=sys.stderr)
    nodegraph = khmer_args.create_nodegraph(args, device=args.device)

    for _, filename in enumerate(args.input_filenames):
        print('consuming input', filename, file=sys.stderr)
        nodegraph.consume_seqfile_and_tag(filename)

    # 0.18 is ACTUAL MAX. Do not change.
    fp_rate = calc_expected_collisions(nodegraph, args.force,
                                       max_false_pos=.15)
    print('fp rate estimated to be %1.3f' % fp_rate, file=sys.stderr)

    # partition-graph
    stop_big_traversals = args.no_big_traverse
    if stop_big_traversals:
        print('** This script brakes for lumps: ',
              'stop_big_traversals is true.', file=sys.stderr)
    else:
        print('** Traverse all the things:',
              ' stop_big_traversals is false.', file=sys.stderr)

    divvy = nodegraph.divide_tags_into_subsets(int(args.subset_size))
    divvy = list(divvy)
    n_subsets = len(divvy)
    divvy.append(0)

    print('enqueued %d subset tasks' % n_subsets, file=sys.stderr)
    open('%s.info' % args.graphbase, 'w').write('%d subsets total\n'
                                                % (n_subsets))

    for index in range(n_subsets):
        start = divvy[index]
        end = divvy[index + 1]
        outfile = args.graphbase + '.subset.%d.pmap' % (index,)
        if os.path.exists(outfile):
            print('SKIPPING', outfile, ' -- already exists',
                  file=sys.stderr)
            continue
        print('starting:', args.graphbase, index, file=sys.stderr)
        subset = nodegraph.do_subset_partition(start, end, True,
                                               stop_big_traversals)
        print('saving:', args.graphbase, index, file=sys.stderr)
        subset.save_partitionmap(outfile)

    print('---', file=sys.stderr)
    print('done making subsets! see %s.subset.*.pmap' %
          (args.graphbase,), file=sys.stderr)

    # merge-partitions
    pmap_files = glob.glob(args.graphbase + '.subset.*.pmap')

    print('loading %d pmap files (first one: %s)' %
          (len(pmap_files), pmap_files[0]), file=sys.stderr)

    nodegraph = Nodegraph(args.ksize, 1, 1, device=args.device)

    for pmap_file in pmap_files:
        print('merging', pmap_file, file=sys.stderr)
        nodegraph.merge_subset_from_disk(pmap_file)

    if args.remove_subsets:
        print('removing pmap files', file=sys.stderr)
        for pmap_file in pmap_files:
            os.unlink(pmap_file)

    # annotate-partitions
    for infile in args.input_filenames:
        print('outputting partitions for', infile, file=sys.stderr)
        outfile = os.path.basename(infile) + '.part'
        part_count = nodegraph.output_partitions(infile, outfile)
        print('output %d partitions for %s' % (
            part_count, infile), file=sys.stderr)
        print('partitions are in', outfile, file=sys.stderr)


if __name__ == '__main__':
    main()
