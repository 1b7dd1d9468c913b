#!/usr/bin/env python
"""Separate partition-annotated sequences into grouped files.

Counterpart of khmer_tpu/cli/extract_partitions.py (the reference
scripts/extract-partitions.py), on the host: it reads the .part files
that annotate-partitions writes and uses no sketch. The same flags and
outputs.

% python -m khmer_tpu_torch.cli.extract_partitions <base> <file1.part> [...]
"""

import sys
import textwrap

from khmer_tpu_torch.cli.args import KhmerArgumentParser, sanitize_help
from khmer_tpu_torch.io.fastx import FastxParser, write_record
from khmer_tpu_torch.utils.kfile import (add_output_compression_type,
                                         check_input_files, check_space,
                                         get_file_writer)

DEFAULT_MAX_SIZE = int(1e6)
DEFAULT_THRESHOLD = 5


class PartitionedReader:
    """Iterate (record, partition_id) from .part-annotated files."""

    def __init__(self, file_list, one_file=False, stop_early=False):
        self.file_list = file_list
        self.one_file = one_file
        self.stop_early = stop_early

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __iter__(self):
        files = self.file_list[:1] if self.one_file else self.file_list
        for filename in files:
            for record in FastxParser(filename):
                name, _, pid = record.name.rpartition("\t")
                if not name:
                    raise ValueError(
                        "read %r is not partition-annotated"
                        % record.name)
                record.name = name
                yield record, int(pid)
                if self.stop_early:
                    return


class PartitionExtractor:
    """Extraction/accounting of partitioned reads (reference :136)."""

    def __init__(self, file_list, min_size, max_size):
        self.file_list = file_list
        self.n_unassigned = 0
        self.count = {}
        self.divvy = None
        self.group_n = 0
        self.group_d = {}
        self.min_size = min_size
        self.max_size = max_size

    def process_unassigned(self, outfp=None):
        with PartitionedReader(self.file_list) as reader:
            for read, pid in reader:
                self.count[pid] = self.count.get(pid, 0) + 1
                if pid == 0:
                    self.n_unassigned += 1
                    if outfp:
                        write_record(read, outfp)

    def output_histogram(self, dist_filename):
        dist = {}
        for _, size in list(self.count.items()):
            dist[size] = dist.get(size, 0) + 1
        distfp = open(dist_filename, 'w')
        total = 0
        wtotal = 0
        for counter, index in sorted(dist.items()):
            total += index
            wtotal += counter * index
            distfp.write('%d %d %d %d\n' % (counter, index, total,
                                            wtotal))
        distfp.close()

    def develop_groups(self):
        if 0 in self.count:
            del self.count[0]
        self.divvy = sorted(list(self.count.items()), key=lambda y: y[1])
        self.divvy = [y for y in self.divvy if y[1] > self.min_size]
        total = 0
        group = set()
        for partition_id, n_reads in self.divvy:
            group.add(partition_id)
            total += n_reads
            if total > self.max_size:
                for partition_id in group:
                    self.group_d[partition_id] = self.group_n
                self.group_n += 1
                group = set()
                total = 0
        if group:
            for partition_id in group:
                self.group_d[partition_id] = self.group_n
            self.group_n += 1

    class ReadGroupGenerator:
        def __init__(self, extractor):
            self.extractor = extractor
            self.total_seqs = 0
            self.part_seqs = 0
            self.toosmall_parts = 0

        def __call__(self, reader):
            for read, partition_id in reader:
                self.total_seqs += 1
                if partition_id == 0:
                    continue
                try:
                    group_n = self.extractor.group_d[partition_id]
                except KeyError:
                    assert self.extractor.count[partition_id] <= \
                        self.extractor.min_size
                    self.toosmall_parts += 1
                    continue
                yield read, group_n
                self.part_seqs += 1


def get_parser():
    epilog = """
    Example (results will be in ``example.group0000.fa``)::

        load-graph.py -k 20 example tests/test-data/random-20-a.fa
        partition-graph.py example
        merge-partitions.py -k 20 example
        annotate-partitions.py -k 20 example tests/test-data/random-20-a.fa
        extract-partitions.py example random-20-a.fa.part

    (:program:`extract-partitions.py` will produce a partition size
    distribution in <base>.dist. The columns are: (1) number of reads,
    (2) count of partitions with n reads, (3) cumulative sum of
    partitions, (4) cumulative sum of reads.)
    """
    parser = KhmerArgumentParser(
        description="Separate sequences that are annotated with "
        "partitions into grouped files.",
        epilog=textwrap.dedent(epilog), citations=['graph'])
    parser.add_argument('prefix', metavar='output_filename_prefix')
    parser.add_argument('part_filenames',
                        metavar='input_partition_filename', nargs='+')
    parser.add_argument('-X', '--max-size', dest='max_size',
                        default=DEFAULT_MAX_SIZE, type=int,
                        help='Max group size (n sequences)')
    parser.add_argument('-m', '--min-partition-size',
                        dest='min_part_size',
                        default=DEFAULT_THRESHOLD, type=int,
                        help='Minimum partition size worth keeping')
    parser.add_argument('-n', '--no-output-groups', dest='output_groups',
                        default=True, action='store_false',
                        help='Do not actually output groups files.')
    parser.add_argument('-U', '--output-unassigned', default=False,
                        action='store_true',
                        help='Output unassigned sequences, too')
    parser.add_argument('-f', '--force', default=False,
                        action='store_true',
                        help='Overwrite output file if it exists')
    add_output_compression_type(parser)
    return parser


def main(argv=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    distfilename = args.prefix + '.dist'

    for infile in args.part_filenames:
        check_input_files(infile, args.force)

    check_space(args.part_filenames, args.force)

    print('---', file=sys.stderr)
    print('reading partitioned files:', repr(
        args.part_filenames), file=sys.stderr)
    if args.output_groups:
        print('outputting to files named "%s.groupN.fa"' %
              args.prefix, file=sys.stderr)
        print('min reads to keep a partition:',
              args.min_part_size, file=sys.stderr)
        print('max size of a group file:', args.max_size,
              file=sys.stderr)
    else:
        print('NOT outputting groups! Beware!', file=sys.stderr)

    if args.output_unassigned:
        print('outputting unassigned reads to "%s.unassigned.fa"' %
              args.prefix, file=sys.stderr)
    print('partition size distribution will go to %s'
          % distfilename, file=sys.stderr)
    print('---', file=sys.stderr)

    suffix = None
    is_fastq = None

    with PartitionedReader(args.part_filenames, True, True) as reader:
        for read, _ in reader:
            if is_fastq is None:
                is_fastq = read.quality is not None
            else:
                assert (read.quality is not None) == is_fastq, \
                    "Input files must have consistent format."

    suffix = "fq" if is_fastq else "fa"

    extractor = PartitionExtractor(args.part_filenames,
                                   args.min_part_size,
                                   args.max_size)

    if args.output_unassigned:
        ofile = open('%s.unassigned.%s' % (args.prefix, suffix), 'wb')
        unassigned_fp = get_file_writer(ofile, args.gzip, args.bzip)
        extractor.process_unassigned(unassigned_fp)
        unassigned_fp.close()
    else:
        extractor.process_unassigned()

    extractor.output_histogram(distfilename)

    if not args.output_groups:
        sys.exit(0)

    extractor.develop_groups()

    print('%d groups' % extractor.group_n, file=sys.stderr)
    if extractor.group_n == 0:
        print('nothing to output; exiting!', file=sys.stderr)
        return

    group_fps = {}
    for index in range(extractor.group_n):
        fname = '%s.group%04d.%s' % (args.prefix, index, suffix)
        group_fp = get_file_writer(open(fname, 'wb'), args.gzip,
                                   args.bzip)
        group_fps[index] = group_fp

    read_generator = PartitionExtractor.ReadGroupGenerator(extractor)

    with PartitionedReader(args.part_filenames) as reader:
        for read, group_n in read_generator(reader):
            outfp = group_fps[group_n]
            write_record(read, outfp)

    print('---', file=sys.stderr)
    print('Of %d total seqs,' % read_generator.total_seqs,
          file=sys.stderr)
    print('extracted %d partitioned seqs into group files,' %
          read_generator.part_seqs, file=sys.stderr)
    print('discarded %d sequences from small partitions (see -m),' %
          read_generator.toosmall_parts, file=sys.stderr)
    print('and found %d unpartitioned sequences (see -U).' %
          extractor.n_unassigned, file=sys.stderr)
    print('', file=sys.stderr)
    print('Created %d group files named %s.groupXXXX.%s' %
          (len(group_fps), args.prefix, suffix), file=sys.stderr)


if __name__ == '__main__':
    main()
