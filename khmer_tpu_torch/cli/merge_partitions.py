#!/usr/bin/env python
"""Merge multiple .pmap subset files into one merged pmap.

Counterpart of khmer_tpu/cli/merge_partitions.py (the reference
scripts/merge-partitions.py): the subsets merge in the order glob gives
their files, on the host; the nodegraph that holds the partition is the
reference's one-byte table, made on --device.

% python -m khmer_tpu_torch.cli.merge_partitions <graphbase>
"""

import glob
import os
import sys
import textwrap

from khmer_tpu_torch import Nodegraph
from khmer_tpu_torch.cli.args import (DEFAULT_K, KhmerArgumentParser,
                                sanitize_help)
from khmer_tpu_torch.utils.kfile import check_input_files, check_space


def get_parser():
    epilog = """\
    Take the ${graphbase}.subset.#.pmap files and merge them all into a
    single ${graphbase}.pmap.merged file for
    :program:`annotate-partitions.py` to use.
    """
    parser = KhmerArgumentParser(
        description="Merge partition map '.pmap' files.",
        epilog=textwrap.dedent(epilog), citations=['graph'])
    parser.add_argument('graphbase', help='basename for input and output '
                        'files')
    parser.add_argument('--keep-subsets', dest='remove_subsets',
                        default=True, action='store_false',
                        help='Keep individual subsets')
    parser.add_argument('--ksize', '-k', type=int, default=DEFAULT_K,
                        help='k-mer size (default: %d)' % DEFAULT_K)
    parser.add_argument('-f', '--force', default=False,
                        action='store_true')
    parser.add_argument('--device', default='cuda',
                        help="PyTorch device that holds the nodegraph, "
                        "e.g. 'cuda', 'cuda:1' or 'cpu'.")
    return parser


def main(argv=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    output_file = args.graphbase + '.pmap.merged'
    pmap_files = glob.glob(args.graphbase + '.subset.*.pmap')

    print('loading %d pmap files (first one: %s)' %
          (len(pmap_files), pmap_files[0]), file=sys.stderr)

    ksize = args.ksize
    nodegraph = Nodegraph(ksize, 1, 1, device=args.device)

    for _ in pmap_files:
        check_input_files(_, args.force)

    check_space(pmap_files, args.force)

    for pmap_file in pmap_files:
        print('merging', pmap_file, file=sys.stderr)
        nodegraph.merge_subset_from_disk(pmap_file)

    print('saving merged to', output_file, file=sys.stderr)
    nodegraph.save_partitionmap(output_file)

    if args.remove_subsets:
        print('removing pmap files', file=sys.stderr)
        for pmap_file in pmap_files:
            os.unlink(pmap_file)


if __name__ == '__main__':
    main()
