#!/usr/bin/env python
"""Count the median/avg k-mer abundance for each sequence.

PyTorch port of khmer_tpu/cli/count_median.py (reference
scripts/count-median.py): the same arguments and CSV, plus --device. The
counts are read on the countgraph's device a window of reads at a time
(kernel H's counts mode on the card, core/pipeline.py counts_for_records),
a count of 255 through the bigcount map; the median, average and standard
deviation are the reference's (core/sketch.py median_avg_stddev_rows,
the reads of a window with as many k-mers taken together).

% python -m khmer_tpu_torch.cli.count_median <htname> <input> <output>
"""

import csv
import sys
import textwrap

import numpy as np

from khmer_tpu_torch import load_countgraph
from khmer_tpu_torch.cli.args import (FileType as khFileType,
                                      KhmerArgumentParser, sanitize_help)
from khmer_tpu_torch.core import pipeline
from khmer_tpu_torch.core.sketch import median_avg_stddev_rows
from khmer_tpu_torch.io.fastx import FastxParser, clean_dna_script
from khmer_tpu_torch.utils.kfile import check_input_files, check_space


def get_parser():
    epilog = """\
    Count the median/avg k-mer abundance for each sequence in the input
    file, based on the k-mer counts in the given k-mer countgraph.  Can be
    used to estimate expression levels (mRNAseq) or coverage
    (genomic/metagenomic).

    The output file contains sequence id, median, average, stddev, and
    seq length, in comma-separated value (CSV) format.

    Example::

        load-into-counting.py counts tests/test-data/test-reads.fq.gz
        count-median.py counts tests/test-data/test-reads.fq.gz medians.txt

    NOTE: All 'N's in the input sequences are converted to 'A's.
    """
    parser = KhmerArgumentParser(
        description='Count k-mers summary stats for sequences',
        epilog=textwrap.dedent(epilog), citations=['counting'])

    parser.add_argument('countgraph', metavar='input_count_graph_filename',
                        help='input k-mer countgraph filename')
    parser.add_argument('input', metavar='input_sequence_filename',
                        help='input FAST[AQ] sequence filename')
    parser.add_argument('output', metavar='output_summary_filename',
                        help='output summary filename',
                        type=khFileType('w'))
    parser.add_argument('-f', '--force', default=False,
                        action='store_true',
                        help='Overwrite output file if it exists')
    parser.add_argument('--device', default='cuda',
                        help="PyTorch device that holds the countgraph, "
                        "e.g. 'cuda', 'cuda:1' or 'cpu'.")
    return parser


def main(argv=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    htfile = args.countgraph
    input_filename = args.input
    output = args.output

    infiles = [htfile, input_filename]
    for infile in infiles:
        check_input_files(infile, args.force)

    check_space(infiles, args.force)

    print('loading k-mer countgraph from', htfile, file=sys.stderr)
    countgraph = load_countgraph(htfile, device=args.device)
    ksize = countgraph.ksize()
    print('writing to', output.name, file=sys.stderr)

    writer = csv.writer(output)
    writer.writerow(['name', 'median', 'average', 'stddev', 'seqlen'])

    def cleaned_records():
        for record in FastxParser(input_filename):
            # the script's cleaning: upper case, N -> A
            record.cleaned_seq = clean_dna_script(record.sequence)
            if ksize <= len(record.cleaned_seq):
                yield record

    window = []
    for pair in pipeline.counts_for_records(countgraph, cleaned_records()):
        window.append(pair)
        if len(window) >= pipeline.COUNTS_WINDOW:
            writer.writerows(_summaries(window))
            window = []
    writer.writerows(_summaries(window))
    if output is not sys.stdout:
        output.close()


def _summaries(window):
    """The CSV rows of a window of (record, counts) pairs, in order: the
    statistics of the reads with as many k-mers taken together
    (median_avg_stddev_rows), each as a Python float rounded to 9
    places."""
    by_len = {}
    for i, (_, counts) in enumerate(window):
        by_len.setdefault(len(counts), []).append(i)
    stats = [None] * len(window)
    for rows in by_len.values():
        med, avg, std = median_avg_stddev_rows(
            np.stack([window[i][1] for i in rows]))
        for i, m, a, s in zip(rows, med.tolist(), avg.tolist(),
                              std.tolist()):
            stats[i] = (m, round(a, 9), round(s, 9))
    return [[record.name, m, a, s, len(record.sequence)]
            for (record, _), (m, a, s) in zip(window, stats)]


if __name__ == '__main__':
    main()
