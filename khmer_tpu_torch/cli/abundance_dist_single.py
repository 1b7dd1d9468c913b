#!/usr/bin/env python
"""Calculate the k-mer abundance distribution, counting in-process.

PyTorch port of khmer_tpu/cli/abundance_dist_single.py (reference
scripts/abundance-dist-single.py): the same flags and outputs, plus
--device. Counting runs the exact byte-layout update (kernel A), the
histogram the tracking update, the count gather (kernel B) and the
histogram scatter-add (kernel C).

% python -m khmer_tpu_torch.cli.abundance_dist_single <data> <histout>
"""

import csv
import os
import sys
import textwrap

from khmer_tpu_torch import calc_expected_collisions
from khmer_tpu_torch.cli import args as khmer_args
from khmer_tpu_torch.cli.abundance_dist import HEADER, write_rows
from khmer_tpu_torch.cli.args import (add_threading_args,
                                      build_counting_args,
                                      calculate_graphsize,
                                      create_matching_nodegraph,
                                      report_on_config, sanitize_help)
from khmer_tpu_torch.utils.kfile import (check_input_files, check_space,
                                         check_space_for_graph)
from khmer_tpu_torch.utils.logger import (configure_logging, log_error,
                                          log_info)


def get_parser():
    epilog = """\
    Note that with :option:`-b`/:option:`--no-bigcount` this script is
    constant memory; in exchange, k-mer counts will stop at 255. The memory
    usage of this script with :option:`-b` will be about 1.15x the product
    of the :option:`-x` and :option:`-N` numbers.

    To count k-mers in multiple files use :program:`load_into_counting.py`
    and :program:`abundance_dist.py`.

    Example::

        abundance-dist-single.py -x 1e7 -N 2 -k 17 \\
                tests/test-data/test-abund-read-2.fa test-dist
    """
    parser = build_counting_args(
        descr="Calculate the abundance distribution of k-mers from a "
        "single sequence file.", epilog=textwrap.dedent(epilog),
        citations=['counting'])
    add_threading_args(parser)

    parser.add_argument('input_sequence_filename', help='The name of the '
                        'input FAST[AQ] sequence file.')
    parser.add_argument('output_histogram_filename', help='The name of '
                        'the output histogram file. The columns are: (1) '
                        'k-mer abundance, (2) k-mer count, (3) cumulative '
                        'count, (4) fraction of total distinct k-mers.')
    parser.add_argument('-z', '--no-zero', dest='output_zero',
                        default=True, action='store_false',
                        help='Do not output zero-count bins')
    parser.add_argument('-b', '--no-bigcount', dest='bigcount',
                        default=True, action='store_false',
                        help='Do not count k-mers past 255')
    parser.add_argument('-s', '--squash', dest='squash_output',
                        default=False, action='store_true',
                        help='Overwrite existing output_histogram_filename')
    parser.add_argument('--savegraph', default=None, metavar="filename",
                        help="Save the k-mer countgraph to the specified "
                        "filename.")
    parser.add_argument('-f', '--force', default=False,
                        action='store_true',
                        help='Override sanity checks')
    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    parser.add_argument('--device', default='cuda',
                        help="PyTorch device that holds the countgraph, "
                        "e.g. 'cuda', 'cuda:1' or 'cpu'.")
    return parser


def main(argv=None):
    args = sanitize_help(get_parser()).parse_args(argv)
    configure_logging(args.quiet)

    check_input_files(args.input_sequence_filename, args.force)
    check_space([args.input_sequence_filename], args.force)
    if args.savegraph is not None:
        graphsize = calculate_graphsize(args, 'countgraph')
        check_space_for_graph(args.savegraph, graphsize, args.force)

    report_on_config(args)

    if (not args.squash_output
            and os.path.exists(args.output_histogram_filename)):
        log_error('ERROR: {output} exists; not squashing.',
                  output=args.output_histogram_filename)
        sys.exit(1)
    # opened, with its header, before counting, as the JAX CLI does: '-'
    # is a file of that name, and a run that finds nothing leaves the
    # header alone
    with open(args.output_histogram_filename, 'w') as hist_fp:
        hist_fp_csv = csv.writer(hist_fp)
        hist_fp_csv.writerow(HEADER)
        hist_fp.flush()
        _count_and_write(args, hist_fp_csv)


def _count_and_write(args, hist_fp_csv):
    """Count the input twice (the table, then the histogram) and write
    the histogram's rows after the header."""
    log_info('making countgraph on {device}', device=args.device)
    # 8/(9+eps) of memory for the countgraph, the rest for tracking
    countgraph = khmer_args.create_countgraph(args,
                                              multiplier=8 / (9. + 0.3),
                                              device=args.device)

    log_info('building k-mer tracking graph')
    tracking = create_matching_nodegraph(countgraph)

    log_info('kmer_size: {ksize}', ksize=countgraph.ksize())
    log_info('k-mer countgraph sizes: {sizes}',
             sizes=countgraph.hashsizes())
    log_info('outputting to {output}',
             output=args.output_histogram_filename)

    log_info('consuming input, round 1 -- {input}',
             input=args.input_sequence_filename)
    countgraph.consume_seqfile(args.input_sequence_filename)

    log_info('Total number of unique k-mers: {nk}',
             nk=countgraph.n_unique_kmers())

    log_info('preparing hist from {seqfile}...',
             seqfile=args.input_sequence_filename)
    log_info('consuming input, round 2 -- {filename}',
             filename=args.input_sequence_filename)
    abundances = countgraph.abundance_distribution(
        args.input_sequence_filename, tracking)

    if 0 == sum(abundances):
        log_error("ERROR: abundance distribution is uniformly zero; "
                  "nothing to report.")
        log_error("\tPlease verify that the input files are valid.")
        sys.exit(1)

    write_rows(hist_fp_csv, abundances, args.output_zero)

    if args.savegraph is not None:
        log_info('Saving k-mer countgraph to {savegraph}',
                 savegraph=args.savegraph)
        countgraph.save(args.savegraph)

    log_info('Total number of unique k-mers: {nk}',
             nk=countgraph.n_unique_kmers())

    fp_rate = calc_expected_collisions(countgraph, args.force)
    log_info('fp rate estimated to be {fpr:1.3f}', fpr=fp_rate)


if __name__ == '__main__':
    main()
