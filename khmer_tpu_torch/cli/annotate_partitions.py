#!/usr/bin/env python
"""Annotate sequences with partition IDs.

Counterpart of khmer_tpu/cli/annotate_partitions.py (the reference
scripts/annotate-partitions.py): the reads are hashed on the host by the
dense hasher and each takes the partition of its first tagged k-mer; the
nodegraph that holds the partition map is the reference's one-byte
table, made on --device.

% python -m khmer_tpu_torch.cli.annotate_partitions <graphbase> <file1> [ <file2> ... ]
"""

import os
import sys
import textwrap

from khmer_tpu_torch import Nodegraph
from khmer_tpu_torch.cli.args import (DEFAULT_K, KhmerArgumentParser,
                                sanitize_help)
from khmer_tpu_torch.utils.kfile import check_input_files, check_space


def get_parser():
    epilog = """\
    Load in a partitionmap (generally produced by
    :program:`partition-graph.py` or :program:`merge-partitions.py`)
    and annotate the sequences in the given files with their partition
    IDs. Use :program:`extract-partitions.py` to extract sequences into
    separate group files.

    Example (results will be in ``random-20-a.fa.part``)::

        load-graph.py -k 20 example tests/test-data/random-20-a.fa
        partition-graph.py example
        merge-partitions.py -k 20 example
        annotate-partitions.py -k 20 example tests/test-data/random-20-a.fa
    """
    parser = KhmerArgumentParser(
        description="Annotate sequences with partition IDs.",
        epilog=textwrap.dedent(epilog), citations=['graph'])

    parser.add_argument('--ksize', '-k', type=int, default=DEFAULT_K,
                        help="k-mer size (default: %d)" % DEFAULT_K)
    parser.add_argument('graphbase', help='basename for input and output '
                        'files')
    parser.add_argument('input_filenames', metavar='input_sequence_filename',
                        nargs='+', help='input FAST[AQ] sequences to '
                        'annotate.')
    parser.add_argument('-f', '--force', default=False,
                        action='store_true')
    parser.add_argument('--device', default='cuda',
                        help="PyTorch device that holds the nodegraph, "
                        "e.g. 'cuda', 'cuda:1' or 'cpu'.")
    return parser


def main(argv=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    ksize = args.ksize
    filenames = args.input_filenames
    nodegraph = Nodegraph(ksize, 1, 1, device=args.device)

    partitionmap_file = args.graphbase + '.pmap.merged'

    check_input_files(partitionmap_file, args.force)
    for _ in filenames:
        check_input_files(_, args.force)

    check_space(filenames, args.force)

    print('loading partition map from:', partitionmap_file,
          file=sys.stderr)
    nodegraph.load_partitionmap(partitionmap_file)

    for infile in filenames:
        print('outputting partitions for', infile, file=sys.stderr)
        outfile = os.path.basename(infile) + '.part'
        part_count = nodegraph.output_partitions(infile, outfile)
        print('output %d partitions for %s' % (
            part_count, infile), file=sys.stderr)
        print('partitions are in', outfile, file=sys.stderr)


if __name__ == '__main__':
    main()
