#!/usr/bin/env python
"""Trim sequences at a minimum k-mer abundance using a saved countgraph.

PyTorch port of khmer_tpu/cli/filter_abund.py (reference
scripts/filter-abund.py): the same flags and outputs, plus --device. The
per-read counts are read on the countgraph's device a window of reads at
a time (kernel H on the card, core/diginorm_scan.py read_counts_window),
the bigcount map included, as JAX's pipeline.counts_for_records reads it;
a SmallCountgraph's (filter-abund-single --small-count) through the
port's pipeline.counts_for_records (kernel Q on the card).

% python -m khmer_tpu_torch.cli.filter_abund <counting.ct> <data1> [ ... ]
"""

import os
import sys
import textwrap

from khmer_tpu_torch import load_countgraph
from khmer_tpu_torch.cli.args import (FileType as khFileType,
                                      KhmerArgumentParser,
                                      add_threading_args,
                                      check_argument_range, sanitize_help)
from khmer_tpu_torch.core import pipeline
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.diginorm_scan import read_counts_window
from khmer_tpu_torch.io.fastx import ReadParser, write_record
from khmer_tpu_torch.io.pairing import broken_paired_reader
from khmer_tpu_torch.utils.kfile import (add_output_compression_type,
                                         check_input_files, check_space,
                                         get_file_writer)
from khmer_tpu_torch.utils.logger import (configure_logging, log_error,
                                          log_info)
from khmer_tpu_torch.utils.trimming import _apply_trim, trim_pos_from_counts

DEFAULT_NORMALIZE_LIMIT = 20
DEFAULT_CUTOFF = 2
# reads a launch of kernel H and a read of its results
WINDOW = 16384


def get_parser():
    epilog = """\
    Trimmed sequences will be placed in
    ``${input_sequence_filename}.abundfilt`` for each input sequence file.
    If the input sequences are from RNAseq or metagenome sequencing then
    :option:`--variable-coverage` should be used.

    Example::

        load-into-counting.py -k 20 -x 5e7 countgraph data/100k-filtered.fa
        filter-abund.py -C 2 countgraph data/100k-filtered.fa
    """
    parser = KhmerArgumentParser(
        description='Trim sequences at a minimum k-mer abundance.',
        epilog=textwrap.dedent(epilog),
        citations=['counting'])
    parser.add_argument('input_graph',
                        metavar='input_count_graph_filename',
                        help='The input k-mer countgraph filename')
    parser.add_argument('input_filename',
                        metavar='input_sequence_filename',
                        help='Input FAST[AQ] sequence filename', nargs='+')
    add_threading_args(parser)
    parser.add_argument('-C', '--cutoff', dest='cutoff',
                        default=DEFAULT_CUTOFF,
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
    parser.add_argument('-o', '--output', dest='single_output_file',
                        type=khFileType('wb'),
                        metavar="optional_output_filename",
                        help='Output the trimmed sequences into a single '
                        'file with the given filename instead of creating '
                        'a new file for each input file.')
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


def filter_file(graph, filename, outfp, cutoff, variable_coverage,
                normalize_to):
    """Write each read of `filename` to `outfp` trimmed at its first k-mer
    below `cutoff` (dropped if that leaves fewer than k bases); with
    `variable_coverage`, a read whose median count is below `normalize_to`
    is written whole. Counts of 255 read through the bigcount map."""
    ksize = graph.ksize()
    big = None
    if graph.get_use_bigcount() and graph._bigcounts:
        big = K.bigcount_table(graph._bigcounts, graph.device)
    paired_iter = broken_paired_reader(ReadParser(filename),
                                       min_length=ksize, force_single=True)
    window = []
    for _, _, read1, _ in paired_iter:
        window.append(read1)
        if len(window) >= WINDOW:
            _filter_window(graph, window, outfp, cutoff, variable_coverage,
                           normalize_to, big)
            window = []
    _filter_window(graph, window, outfp, cutoff, variable_coverage,
                   normalize_to, big)


def _filter_window(graph, window, outfp, cutoff, variable_coverage,
                   normalize_to, big):
    ksize = graph.ksize()
    if graph.storage_kind != "byte":
        # a SmallCountgraph: each read's counts from kernel Q
        # (pipeline.counts_for_records), as JAX's device path reads them
        trims, n_ge = [], []
        for record, counts in pipeline.counts_for_records(graph, window):
            n = len(record.cleaned_seq)
            trims.append(trim_pos_from_counts(counts, ksize, cutoff, n))
            n_ge.append(int((counts >= normalize_to).sum()))
    else:
        trims, n_ge = read_counts_window(graph, window, cutoff,
                                         normalize_to, big)
    for record, trim_at, ge in zip(window, trims, n_ge):
        # median_at_least_from_counts (utils/trimming.py)
        min_req = int(0.5 + (len(record.cleaned_seq) - ksize + 1) / 2.0)
        if variable_coverage and not ge >= min_req:
            write_record(record, outfp)
            continue
        trimmed_record, _ = _apply_trim(ksize, record, int(trim_at))
        if trimmed_record:
            write_record(trimmed_record, outfp)


def main(argv=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    configure_logging(args.quiet)

    infiles = args.input_filename
    if ('-' in infiles or '/dev/stdin' in infiles) and not \
       args.single_output_file:
        log_error("Accepting input from stdin; output filename must "
                  "be provided with -o.")
        sys.exit(1)

    for filename in infiles:
        check_input_files(filename, args.force)

    check_space(infiles, args.force)

    log_info('loading countgraph: {graph}', graph=args.input_graph)
    countgraph = load_countgraph(args.input_graph, device=args.device)
    ksize = countgraph.ksize()

    log_info("K: {ksize}", ksize=ksize)

    if args.single_output_file:
        outfile = args.single_output_file.name
        outfp = get_file_writer(args.single_output_file, args.gzip,
                                args.bzip)

    for infile in infiles:
        log_info('filtering {infile}', infile=infile)
        if not args.single_output_file:
            outfile = os.path.basename(infile) + '.abundfilt'
            outfp = open(outfile, 'wb')
            outfp = get_file_writer(outfp, args.gzip, args.bzip)

        filter_file(countgraph, infile, outfp, args.cutoff,
                    args.variable_coverage, args.normalize_to)

        log_info('output in {outfile}', outfile=outfile)


if __name__ == '__main__':
    main()
