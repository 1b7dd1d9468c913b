#!/usr/bin/env python
"""Trim sequences at a minimum k-mer abundance, counting in-process.

PyTorch port of khmer_tpu/cli/filter_abund_single.py (reference
scripts/filter-abund-single.py): the same flags and outputs, plus
--device. Counting runs the exact byte-layout update (kernel A), the
filtering reads the per-read counts a window at a time (kernel H,
cli/filter_abund.py filter_file).

% python -m khmer_tpu_torch.cli.filter_abund_single <data>
"""

import os
import textwrap

from khmer_tpu_torch import calc_expected_collisions
from khmer_tpu_torch.cli import args as khmer_args
from khmer_tpu_torch.cli.args import (add_threading_args,
                                      build_counting_args,
                                      calculate_graphsize,
                                      check_argument_range, report_on_config,
                                      sanitize_help)
from khmer_tpu_torch.cli.filter_abund import filter_file
from khmer_tpu_torch.utils.kfile import (add_output_compression_type,
                                         check_input_files, check_space,
                                         check_space_for_graph,
                                         get_file_writer)
from khmer_tpu_torch.utils.logger import configure_logging, log_info

DEFAULT_NORMALIZE_LIMIT = 20
DEFAULT_CUTOFF = 2


def get_parser():
    epilog = """\
    Trimmed sequences will be placed in ``${input_sequence_filename}
    .abundfilt``.

    This script is constant memory.

    To trim reads based on k-mer abundance across multiple files, use
    :program:`load-into-counting.py` and :program:`filter-abund.py`.

    Example::

        filter-abund-single.py -k 20 -x 5e7 -C 2 data/100k-filtered.fa
    """
    parser = build_counting_args(
        descr="Trims sequences at a minimum k-mer abundance "
        "(in memory version).", epilog=textwrap.dedent(epilog),
        citations=['counting'])
    add_threading_args(parser)

    parser.add_argument('--cutoff', '-C', default=DEFAULT_CUTOFF,
                        type=check_argument_range(0, 256, 'cutoff'),
                        help="Trim at k-mers below this abundance.")
    parser.add_argument('-V', '--variable-coverage', action='store_true',
                        dest='variable_coverage', default=False,
                        help='Only trim low-abundance k-mers from '
                        'sequences that have high coverage.')
    parser.add_argument('-Z', '--normalize-to', type=int,
                        dest='normalize_to',
                        help='Base the variable-coverage cutoff on this '
                        'median k-mer abundance.',
                        default=DEFAULT_NORMALIZE_LIMIT)
    parser.add_argument('--savegraph', metavar="filename", default='',
                        help="If present, the name of the file to save "
                        "the k-mer countgraph to")
    parser.add_argument('-o', '--outfile',
                        metavar='optional_output_filename',
                        default=None, help='Override default output '
                        'filename and output trimmed sequences into a '
                        'file with the given filename.')
    parser.add_argument('datafile', metavar='input_sequence_filename',
                        help="FAST[AQ] sequence file to trim")
    parser.add_argument('-f', '--force', default=False,
                        action='store_true',
                        help='Overwrite output file if it exists')
    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    add_output_compression_type(parser)
    parser.add_argument('--device', default='cuda',
                        help="PyTorch device that holds the countgraph, "
                        "e.g. 'cuda', 'cuda:1' or 'cpu'.")
    return parser


def main(argv=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    configure_logging(args.quiet)
    check_input_files(args.datafile, args.force)
    check_space([args.datafile], args.force)

    if args.savegraph:
        tablesize = calculate_graphsize(args, 'countgraph')
        check_space_for_graph(args.savegraph, tablesize, args.force)

    report_on_config(args)

    log_info('making countgraph on {device}', device=args.device)
    graph = khmer_args.create_countgraph(args, device=args.device)

    log_info('consuming input, round 1 -- {datafile}',
             datafile=args.datafile)
    graph.consume_seqfile(args.datafile)

    log_info('Total number of unique k-mers: {nk}',
             nk=graph.n_unique_kmers())

    fp_rate = calc_expected_collisions(graph, args.force)
    log_info('fp rate estimated to be {fpr:1.3f}', fpr=fp_rate)

    log_info('filtering {datafile}', datafile=args.datafile)
    if args.outfile is None:
        outfile = os.path.basename(args.datafile) + '.abundfilt'
    else:
        outfile = args.outfile
    outfp = open(outfile, 'wb')
    outfp = get_file_writer(outfp, args.gzip, args.bzip)

    filter_file(graph, args.datafile, outfp, args.cutoff,
                args.variable_coverage, args.normalize_to)

    log_info('output in {outfile}', outfile=outfile)

    if args.savegraph:
        log_info('Saving k-mer countgraph filename {graph}',
                 graph=args.savegraph)
        graph.save(args.savegraph)


if __name__ == '__main__':
    main()
