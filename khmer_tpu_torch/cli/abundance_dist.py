#!/usr/bin/env python
"""Calculate abundance distribution of saved countgraph vs sequences.

PyTorch port of khmer_tpu/cli/abundance_dist.py (reference
scripts/abundance-dist.py): the same flags and histogram CSV, plus
--device. The histogram step runs on the device: the tracking table's
update, the count gather (kernel B) and the histogram scatter-add
(kernel C, csrc/histogram.cu).

% python -m khmer_tpu_torch.cli.abundance_dist <counttable> <data> \\
      <histogram>
"""

import csv
import os
import sys
import textwrap

from khmer_tpu_torch import Nodegraph, load_countgraph
from khmer_tpu_torch.cli.args import KhmerArgumentParser, sanitize_help
from khmer_tpu_torch.utils.kfile import check_input_files
from khmer_tpu_torch.utils.logger import (configure_logging, log_error,
                                          log_info, log_warn)


HEADER = ['abundance', 'count', 'cumulative', 'cumulative_fraction']


def write_histogram(path, abundances, output_zero):
    """Write the histogram CSV (abundance, count, cumulative count and
    fraction) to `path`, or to stdout for '-' or '/dev/stdout'; stops
    after the last non-empty bin."""
    if path in ('-', '/dev/stdout'):
        _write_csv(sys.stdout, abundances, output_zero)
    else:
        with open(path, 'w') as fp:
            _write_csv(fp, abundances, output_zero)


def _write_csv(fp, abundances, output_zero):
    writer = csv.writer(fp)
    writer.writerow(HEADER)
    write_rows(writer, abundances, output_zero)


def write_rows(writer, abundances, output_zero):
    """The histogram's rows, after the header, through a csv writer."""
    total = sum(abundances)
    sofar = 0
    for abundance, count in enumerate(abundances):
        if count == 0 and not output_zero:
            continue
        sofar += count
        writer.writerow([abundance, count, sofar,
                         round(sofar / float(total), 3)])
        if sofar == total:
            break


def get_parser():
    epilog = """\
    Example::

        load-into-counting.py -x 1e7 -N 2 -k 17 counts \\
                tests/test-data/test-abund-read-2.fa
        abundance-dist.py counts tests/test-data/test-abund-read-2.fa \\
                test-dist
    """
    parser = KhmerArgumentParser(
        description="Calculate abundance distribution of the k-mers in "
        "the sequence file using a pre-made k-mer countgraph.",
        epilog=textwrap.dedent(epilog), citations=['counting'])

    parser.add_argument('input_count_graph_filename', help='The name of '
                        'the input k-mer countgraph file.')
    parser.add_argument('input_sequence_filename', help='The name of the '
                        'input FAST[AQ] sequence file.')
    parser.add_argument('output_histogram_filename', help='The columns '
                        'are: (1) k-mer abundance, (2) k-mer count, (3) '
                        'cumulative count, (4) fraction of total distinct '
                        'k-mers.')
    parser.add_argument('-z', '--no-zero', dest='output_zero', default=True,
                        action='store_false',
                        help='Do not output zero-count bins')
    parser.add_argument('-s', '--squash', dest='squash_output',
                        default=False, action='store_true',
                        help='Overwrite existing output_histogram_filename')
    parser.add_argument('-b', '--no-bigcount', dest='bigcount',
                        default=True, action='store_false',
                        help='Do not count k-mers past 255')
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Continue even if specified input files '
                        'do not exist or are empty.')
    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    parser.add_argument('--device', default='cuda',
                        help="PyTorch device that holds the countgraph, "
                        "e.g. 'cuda', 'cuda:1' or 'cpu'.")
    return parser


def main(argv=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    configure_logging(args.quiet)

    infiles = [args.input_count_graph_filename,
               args.input_sequence_filename]
    for infile in infiles:
        check_input_files(infile, False)

    log_info('Loading counting graph from {graph}',
             graph=args.input_count_graph_filename)
    countgraph = load_countgraph(args.input_count_graph_filename,
                                 device=args.device)

    if not countgraph.get_use_bigcount() and args.bigcount:
        log_warn("WARNING: The loaded graph has bigcount DISABLED while "
                 "bigcount reporting is ENABLED--counts higher than 255 "
                 "will not be reported.")

    countgraph.set_use_bigcount(args.bigcount)

    kmer_size = countgraph.ksize()
    hashsizes = countgraph.hashsizes()
    tracking = Nodegraph(kmer_size, 1, 1, primes=hashsizes,
                         device=countgraph.device)

    log_info('K: {ksize}', ksize=kmer_size)
    log_info('outputting to {output}',
             output=args.output_histogram_filename)

    if args.output_histogram_filename in ('-', '/dev/stdout'):
        pass
    elif os.path.exists(args.output_histogram_filename):
        if not args.squash_output:
            log_error('ERROR: {output} exists; not squashing.',
                      output=args.output_histogram_filename)
            sys.exit(1)
        log_info('** squashing existing file {output}',
                 output=args.output_histogram_filename)

    log_info('preparing hist...')
    abundances = countgraph.abundance_distribution(
        args.input_sequence_filename, tracking)
    total = sum(abundances)

    if 0 == total:
        log_error("ERROR: abundance distribution is uniformly zero; "
                  "nothing to report.")
        log_error("\tPlease verify that the input files are valid.")
        sys.exit(1)

    write_histogram(args.output_histogram_filename, abundances,
                    args.output_zero)


if __name__ == '__main__':
    main()
