#!/usr/bin/env python
"""Trim sequences at stoptags.

Counterpart of khmer_tpu/cli/filter_stoptags.py (the reference
scripts/filter-stoptags.py), on the host: the reads come in windows of
records, the dense hasher (csrc/dense_hash.cc) hashes a window in one C
call, and each read's first k-mer that is a stop tag comes from a C++
set lookup (ops/host.py U64Set), as the annotation of partitions finds
each read's first tag. The same flags and outputs.

% python -m khmer_tpu_torch.cli.filter_stoptags <stoptags> <data1> [...]
"""

import os
import sys
import textwrap

import numpy as np

from khmer_tpu_torch.cli.args import (DEFAULT_K, KhmerArgumentParser,
                                      sanitize_help)
from khmer_tpu_torch.core import hostengine, oxli_io
from khmer_tpu_torch.core.partition import _windows
from khmer_tpu_torch.io.fastx import FastxParser
from khmer_tpu_torch.ops import hashing as H
from khmer_tpu_torch.ops.host import U64Set
from khmer_tpu_torch.utils.kfile import check_input_files, check_space


def get_parser():
    epilog = """\
    Load stoptags in from the given `.stoptags` file and use them to
    trim or remove the sequences in <file1-N>.  Trimmed sequences will
    be placed in ``<fileN>.stopfilt``.
    """
    parser = KhmerArgumentParser(
        description="Trim sequences at stoptags.",
        epilog=textwrap.dedent(epilog), citations=['graph'])
    parser.add_argument('--ksize', '-k', default=DEFAULT_K, type=int,
                        help='k-mer size')
    parser.add_argument('stoptags_file', metavar='input_stoptags_filename')
    parser.add_argument('input_filenames',
                        metavar='input_sequence_filename', nargs='+')
    parser.add_argument('-f', '--force', default=False,
                        action='store_true',
                        help='Overwrite output file if it exists')
    return parser


def trimmed_records(records, stops, k):
    """(name, sequence) of each record kept, in order: a read that holds
    an N is dropped; any other is trimmed at k - 2 + i for its first
    window i that is a stop tag (Hashgraph::trim_on_stoptags) and kept if
    at least k bases and a name are left. stops: a U64Set."""
    for window in _windows(records):
        window = [rec for rec in window if 'N' not in rec.sequence]
        seqs = [rec.sequence for rec in window]
        lens = np.fromiter(map(len, seqs), np.int64, len(seqs))
        nwin = np.where(lens >= k, lens - k + 1, 0)
        flat = hostengine.hash_dense_reads(
            H.encode_dna("".join(seqs)), np.cumsum(lens) - lens, lens, k,
            "twobit")
        first = stops.first_members(flat, nwin)
        starts = np.cumsum(nwin) - nwin
        for rec, seq, at, lo in zip(window, seqs, first.tolist(),
                                    starts.tolist()):
            trim_at = len(seq) if at < 0 else k - 2 + at - lo
            if trim_at >= k and rec.name and seq[:trim_at]:
                yield rec.name, seq[:trim_at]


def main(argv=None):
    args = sanitize_help(get_parser()).parse_args(argv)
    stoptags = args.stoptags_file
    infiles = args.input_filenames

    for _ in infiles:
        check_input_files(_, args.force)

    check_space(infiles, args.force)

    print('loading stop tags, with K', args.ksize, file=sys.stderr)
    stops = U64Set(sorted(oxli_io.load_stoptags(stoptags, args.ksize)))

    try:
        for infile in infiles:
            print('filtering', infile, file=sys.stderr)
            outfile = os.path.basename(infile) + '.stopfilt'

            with open(outfile, 'w') as outfp:
                for name, seq in trimmed_records(FastxParser(infile), stops,
                                                 args.ksize):
                    outfp.write('>%s\n%s\n' % (name, seq))

            print('output in', outfile, file=sys.stderr)
    finally:
        stops.close()


if __name__ == '__main__':
    main()
