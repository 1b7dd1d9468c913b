#!/usr/bin/env python
"""Estimate number of unique k-mers with HyperLogLog.

Counterpart of khmer_tpu/cli/unique_kmers.py (the reference
scripts/unique-kmers.py): the same flags and outputs, plus --device. The
HLL registers live on the device; each input's reads go to them through
kernel K (murmur and register max fused, core/hll.py).

% python -m khmer_tpu_torch.cli.unique_kmers <data1> [ <data2> <...> ]
"""

import argparse
import os
import sys
import textwrap

from khmer_tpu_torch.cli.args import (DEFAULT_K, KhmerArgumentParser,
                                      graphsize_args_report, sanitize_help)
from khmer_tpu_torch.core.hll import HLLCounter


def get_parser():
    descr = "Estimate number of unique k-mers, with precision <= ERROR_RATE."
    epilog = """\
    A HyperLogLog counter is used to do cardinality estimation. Since this
    counter is based on a tradeoff between precision and memory consumption,
    :option:`-e`/:option:`--error-rate` can be used to control how much
    memory will be used. In practice the memory footprint is small even
    at low error rates (< 0.01).

    :option:`-k`/:option:`--ksize` should be set to the desired k-mer size.

    Informational output is sent to STDERR, but a report file can be
    generated with :option:`-R`/:option:`--report`.

    :option:`--stream-records` will write the sequences taken in to STDOUT.
    This is useful for workflows: count unique kmers in a stream, then do
    digital normalization.

    :option:`--diagnostics` will provide detailed options for tablesize
    and memory limitations for various false positive rates. This is
    useful for configuring other khmer scripts. This will be written to
    STDERR.

    Example::

        unique-kmers.py -k 17 tests/test-data/test-abund-read{,-2,-3}.fa

    Example::

        unique-kmers.py -k 17 --diagnostics tests/test-data/test-abund-read.fa

    Example::

        unique-kmers.py --stream-records -k 17 tests/test-data/test-reads.fa | \\
        normalize-by-median.py -k 17 -o normalized /dev/stdin

    Example::

        unique-kmers.py -R unique_count -k 30 \\
        tests/test-data/test-abund-read-paired.fa"""
    parser = KhmerArgumentParser(
        description=descr, epilog=textwrap.dedent(epilog),
        citations=['SeqAn', 'hll'])

    env_ksize = os.environ.get('KHMER_KSIZE', DEFAULT_K)

    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    parser.add_argument('-k', '--ksize', type=int, default=env_ksize,
                        help='k-mer size to use')
    parser.add_argument('-e', '--error-rate', type=float, default=0.01,
                        help='Acceptable error rate')
    parser.add_argument('-R', '--report',
                        metavar='filename', type=argparse.FileType('w'),
                        help='generate informational report and write to'
                        ' filename')
    parser.add_argument('-S', '--stream-records', default=False,
                        action='store_true',
                        help='write input sequences to STDOUT')
    parser.add_argument('--diagnostics', default=False,
                        action='store_true',
                        help='print out recommended tablesize arguments '
                        'and restrictions')
    parser.add_argument('input_filenames',
                        metavar='input_sequence_filename',
                        help='Input FAST[AQ] sequence filename(s).',
                        nargs='+')
    parser.add_argument('--device', default='cuda',
                        help="PyTorch device that holds the HLL registers, "
                        "e.g. 'cuda', 'cuda:1' or 'cpu'.")
    return parser


def main(argv=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    total_hll = HLLCounter(args.error_rate, int(args.ksize),
                           device=args.device)

    report_fp = args.report
    input_filename = None
    for _, input_filename in enumerate(args.input_filenames):
        hll = HLLCounter(args.error_rate, int(args.ksize),
                         device=args.device)
        hll.consume_seqfile(input_filename,
                            stream_records=args.stream_records)

        cardinality = hll.estimate_cardinality()
        print('Estimated number of unique {0}-mers in {1}: {2}'.format(
            args.ksize, input_filename, cardinality), file=sys.stderr)

        if report_fp:
            print(cardinality, args.ksize, '(total)', file=report_fp)
            report_fp.flush()
        total_hll.merge(hll)

    cardinality = total_hll.estimate_cardinality()
    print('Total estimated number of unique {0}-mers: {1}'.format(
        args.ksize, cardinality), file=sys.stderr)

    to_print = graphsize_args_report(cardinality, args.error_rate)
    if args.diagnostics:
        print(to_print, file=sys.stderr)

    if report_fp:
        print(cardinality, args.ksize, 'total', file=report_fp)
        print(to_print, file=report_fp)
        report_fp.flush()


if __name__ == "__main__":
    main()
