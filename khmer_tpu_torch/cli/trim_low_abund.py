#!/usr/bin/env python
"""Trim low-abundance k-mers using a streaming algorithm.

PyTorch port of khmer_tpu/cli/trim_low_abund.py (reference
scripts/trim-low-abund.py: two-pass semi-streaming, with -V variable
coverage and --diginorm): the same flags and outputs, plus --device. Pass
1 is sequential — a consumed bundle's k-mers change later decisions — and
runs on the countgraph's device a window of bundles at a time
(core/diginorm_scan.py ScanTrimmerState: kernel G on the card, updating
the u8 tables in place). Pass 2 reads the finished countgraph (kernel H,
one launch a window). With --small-count (a SmallCountgraph's nibble
tables) both passes walk a window's bundles on the host over one gather
of its counters (core/diginorm.py SeqWindow: kernel R, then kernel P's
commit), as JAX's do. Outputs do not depend on the window size; only the
"..." progress lines come at other reads than the JAX CLI's.

% python -m khmer_tpu_torch.cli.trim_low_abund [ <data1> [ <data2> ... ] ]
"""

import csv
import json
import os
import shutil
import sys
import tempfile
import textwrap

from khmer_tpu_torch import calc_expected_collisions, load_countgraph
from khmer_tpu_torch.cli import args as khmer_args
from khmer_tpu_torch.cli.args import (FileType as khFileType,
                                      add_loadgraph_args,
                                      build_counting_args,
                                      calculate_graphsize, report_on_config,
                                      sanitize_help)
from khmer_tpu_torch.core.diginorm import SeqWindow
from khmer_tpu_torch.core.diginorm_scan import (ScanTrimmerState,
                                                read_counts_window)
from khmer_tpu_torch.io.fastx import ReadParser, write_record
from khmer_tpu_torch.io.pairing import broken_paired_reader
from khmer_tpu_torch.utils.kfile import (add_output_compression_type,
                                         check_space, check_space_for_graph,
                                         check_valid_file_exists,
                                         get_file_writer)
from khmer_tpu_torch.utils.logger import (configure_logging, log_error,
                                          log_info)
from khmer_tpu_torch.utils.trimming import (_apply_trim,
                                            median_at_least_from_counts,
                                            trim_pos_from_counts)

DEFAULT_TRIM_AT_COVERAGE = 20
DEFAULT_CUTOFF = 2
DEFAULT_DIGINORM_COVERAGE = 20
REPORT_EVERY_N_READS = 10000
# bundles per window: one upload, kernel G's three launches (pass 1) or
# one of H (pass 2), and one read of the results each, unless reads longer
# than 4096 bases split it (diginorm_scan.row_runs)
WINDOW = 16384


def get_parser():
    epilog = """\
    The output is one file for each input file, ``<input
    file>.abundtrim``, placed in the current directory.  This output
    contains the input sequences trimmed at low-abundance k-mers.

    The :option:`-V`/:option:`--variable-coverage` parameter will, if
    specified, prevent elimination of low-abundance reads by only
    trimming low-abundance k-mers from high-abundance reads; use this
    for non-genomic data sets that may have variable coverage.

    Note that the output reads will not necessarily be in the same
    order as the reads in the input files; if this is an important
    consideration, use :program:`load-into-counting.py` and
    :program:`filter-abund.py`.  However, read pairs will be kept
    together, in "broken-paired" format; you can use
    :program:`extract-paired-reads.py` to extract read pairs and
    orphans.

    Example::

        trim-low-abund.py -x 5e7 -k 20 -C 2 data/100k-filtered.fa
    """
    parser = build_counting_args(
        descr='Trim low-abundance k-mers using a streaming algorithm.',
        epilog=textwrap.dedent(epilog), citations=['streaming'])

    parser.add_argument('input_filenames', nargs='+')
    parser.add_argument('-C', '--cutoff', type=int,
                        help='remove k-mers below this abundance',
                        default=DEFAULT_CUTOFF)
    parser.add_argument('-Z', '--trim-at-coverage', '--normalize-to',
                        type=int,
                        help='trim reads when entire read above this '
                        'coverage', default=DEFAULT_TRIM_AT_COVERAGE)
    parser.add_argument('-o', '--output', metavar="output_filename",
                        type=khFileType('wb'),
                        help='only output a single file with '
                        'the specified filename; use a single dash "-" to '
                        'specify that output should go to STDOUT (the '
                        'terminal)')
    parser.add_argument('-V', '--variable-coverage', action='store_true',
                        default=False,
                        help='Only trim low-abundance k-mers from '
                        'sequences that have high coverage.')
    add_loadgraph_args(parser)
    parser.add_argument('-s', '--savegraph', metavar="filename",
                        default='',
                        help='save the k-mer countgraph to disk after all'
                        'reads are loaded.')
    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    parser.add_argument('--summary-info', type=str, default=None,
                        metavar="FORMAT", choices=['json', 'tsv'],
                        help="What format should the machine readable "
                        "run summary be in? (`json` or `tsv`, disabled "
                        "by default)")
    parser.add_argument('--force', default=False, action='store_true')
    parser.add_argument('--ignore-pairs', default=False,
                        action='store_true',
                        help='treat all reads as if they were singletons')
    parser.add_argument('-T', '--tempdir', type=str, default='./',
                        help="Set location of temporary directory for "
                        "second pass")
    add_output_compression_type(parser)
    parser.add_argument('--diginorm', default=False, action='store_true',
                        help="Eliminate high-coverage reads altogether "
                        "(digital normalization).")
    parser.add_argument('--diginorm-coverage', type=int,
                        default=DEFAULT_DIGINORM_COVERAGE,
                        help="Coverage threshold for --diginorm")
    parser.add_argument('--single-pass', default=False,
                        action='store_true',
                        help="Do not do a second pass across the low "
                        "coverage data")
    parser.add_argument('--device', default='cuda',
                        help="PyTorch device that holds the countgraph, "
                        "e.g. 'cuda', 'cuda:1' or 'cpu'.")
    return parser


def _windows(reader):
    """The bundles of a broken_paired_reader (one or two records each) in
    windows of WINDOW bundles, the last one shorter."""
    window = []
    for _, _, read1, read2 in reader:
        window.append([r for r in (read1, read2) if r])
        if len(window) >= WINDOW:
            yield window
            window = []
    if window:
        yield window


def _at_least(n_ge, record, k):
    """median_at_least from a read's windows at or above the coverage, as
    the JAX pass 2 takes it: a read shorter than k passes."""
    nvalid = max(len(record.cleaned_seq) - k + 1, 0)
    return n_ge >= int(0.5 + nvalid / 2.0)


class Trimmer:
    """Two-pass trimmer (reference Trimmer, :162-280): on byte tables pass
    1 on the scan (ScanTrimmerState) and pass 2 on the read-only count
    kernel; on nibble tables both over SeqWindow."""

    def __init__(self, graph, do_trim_low_abund, cutoff,
                 trim_at_coverage):
        self.graph = graph
        self.do_trim_low_abund = do_trim_low_abund
        self.cutoff = cutoff
        self.trim_at_coverage = trim_at_coverage
        self.n_reads = 0
        self.n_bp = 0
        self.trimmed_reads = 0
        self.n_saved = 0
        self.n_skipped = 0
        self.bp_skipped = 0
        self.do_normalize = False
        self.diginorm_coverage = None
        self.scan = None

    def set_diginorm(self, coverage):
        self.do_normalize = True
        self.diginorm_coverage = coverage

    def pass1(self, reader, saver):
        if self.graph.storage_kind != "byte":
            for window in _windows(reader):
                yield from self._pass1_host_window(window, saver)
            return
        k = self.graph.ksize()
        if self.scan is None:
            self.scan = ScanTrimmerState(
                self.graph, self.cutoff, self.trim_at_coverage,
                self.diginorm_coverage if self.do_normalize else None)
        for window in _windows(reader):
            branch, trim_at = self.scan.process_window(window)
            for bi, bundle in enumerate(window):
                self.n_reads += len(bundle)
                self.n_bp += sum(len(r.sequence) for r in bundle)
                if branch[bi] == 0:      # --diginorm discard
                    continue
                if branch[bi] == 1:      # high coverage: trim + emit
                    for j, read in enumerate(bundle):
                        record, did_trim = _apply_trim(
                            k, read, int(trim_at[bi, j]))
                        if did_trim:
                            self.trimmed_reads += 1
                        if record:
                            yield record
                else:                    # low coverage: consume + save
                    for read in bundle:
                        write_record(read, saver)
                        self.n_saved += 1

    def _pass1_host_window(self, window, saver):
        """Pass 1 of a window on a SmallCountgraph, as JAX's does
        (cli/trim_low_abund.py _pass1_host_window): kernel R gathers the
        window's counters once, the host walks its bundles in order with
        the adds of the consumed ones (core/diginorm.py SeqWindow), and
        kernel P commits those at the window's end."""
        k = self.graph.ksize()
        seqs = [r.cleaned_seq for b in window for r in b]
        win = SeqWindow(self.graph, seqs)
        si = 0
        for bundle in window:
            idxs = list(range(si, si + len(bundle)))
            si += len(bundle)
            self.n_reads += len(bundle)
            self.n_bp += sum(len(r.sequence) for r in bundle)
            min_coverage = min(win.median(i) for i in idxs)
            if self.do_normalize and min_coverage >= self.diginorm_coverage:
                continue
            if min_coverage >= self.trim_at_coverage:
                for i, read in zip(idxs, bundle):
                    record, did_trim = _apply_trim(k, read, _trim_at(
                        win.counts(i), k, self.cutoff, read))
                    if did_trim:
                        self.trimmed_reads += 1
                    if record:
                        yield record
            else:
                for i, read in zip(idxs, bundle):
                    win.consume(i)
                    write_record(read, saver)
                    self.n_saved += 1
        win.flush()

    def pass2(self, reader):
        """The reads kept aside, against the finished countgraph (no
        bigcount, as the JAX pass 2 reads the tables)."""
        if self.graph.storage_kind != "byte":
            yield from self._pass2_windows(reader)
            return
        k = self.graph.ksize()
        for window in _windows(reader):
            recs = [r for b in window for r in b]
            trims, n_ge = read_counts_window(self.graph, recs, self.cutoff,
                                             self.trim_at_coverage)
            si = 0
            for bundle in window:
                idxs = range(si, si + len(bundle))
                si += len(bundle)
                self.n_reads += len(bundle)
                self.n_bp += sum(len(r.sequence) for r in bundle)
                if self.do_trim_low_abund or \
                        all(_at_least(n_ge[i], recs[i], k) for i in idxs):
                    for i, read in zip(idxs, bundle):
                        record, did_trim = _apply_trim(k, read,
                                                       int(trims[i]))
                        if did_trim:
                            self.trimmed_reads += 1
                        if record:
                            yield record
                else:
                    for read in bundle:
                        self.n_skipped += 1
                        self.bp_skipped += 1
                        yield read

    def _pass2_windows(self, reader):
        """Pass 2 on a SmallCountgraph, as JAX's device engine runs it: a
        window's counts from one gather of kernel R (SeqWindow, nothing
        consumed)."""
        k = self.graph.ksize()
        for window in _windows(reader):
            win = SeqWindow(self.graph,
                            [r.cleaned_seq for b in window for r in b])
            si = 0
            for bundle in window:
                idxs = range(si, si + len(bundle))
                si += len(bundle)
                self.n_reads += len(bundle)
                self.n_bp += sum(len(r.sequence) for r in bundle)
                if self.do_trim_low_abund or all(
                        median_at_least_from_counts(
                            win.counts(i), k, self.trim_at_coverage,
                            len(read.cleaned_seq))
                        for i, read in zip(idxs, bundle)):
                    for i, read in zip(idxs, bundle):
                        record, did_trim = _apply_trim(k, read, _trim_at(
                            win.counts(i), k, self.cutoff, read))
                        if did_trim:
                            self.trimmed_reads += 1
                        if record:
                            yield record
                else:
                    for read in bundle:
                        self.n_skipped += 1
                        self.bp_skipped += 1
                        yield read


def _trim_at(counts, k, cutoff, read):
    """A read's trim position from its window counts (trim_on_abundance)."""
    return trim_pos_from_counts(counts, k, cutoff, len(read.cleaned_seq))


def store_provenance_info(info, fname, format='json'):
    format = format.lower() if format is not None else 'json'
    fname = '{}.info.{}'.format(fname, format)
    if format == 'json':
        with open(fname, 'w') as f:
            json.dump(info, f)
            f.write('\n')
    elif format == 'tsv':
        with open(fname, 'w') as f:
            tsv = csv.DictWriter(f, fieldnames=info.keys(),
                                 dialect='excel-tab')
            tsv.writeheader()
            tsv.writerow(info)
    else:
        raise RuntimeError("File format has to be one of json or tsv"
                           " not {}.".format(format))


def main(argv=None):  # pylint: disable=too-many-branches,too-many-statements
    """Run the command; returns the Trimmer it ran (its ScanTrimmerState's
    scan_runs say how many windows pass 1 scanned)."""
    parser = sanitize_help(get_parser())
    args = parser.parse_args(argv)

    configure_logging(args.quiet)

    if len(set(args.input_filenames)) != len(args.input_filenames):
        log_error("Error: Cannot input the same filename multiple times.")
        sys.exit(1)

    if args.trim_at_coverage != DEFAULT_TRIM_AT_COVERAGE and \
       not args.variable_coverage:
        log_error("Error: --trim-at-coverage/-Z given, but "
                  "--variable-coverage/-V not specified.")
        sys.exit(1)

    if args.diginorm_coverage != DEFAULT_DIGINORM_COVERAGE and \
       not args.diginorm:
        log_error("Error: --diginorm-coverage given, but "
                  "--diginorm not specified.")
        sys.exit(1)

    if args.diginorm and args.single_pass:
        log_error("Error: --diginorm and --single-pass are "
                  "incompatible!\n"
                  "You probably want to use normalize-by-median.py "
                  "instead.")
        sys.exit(1)

    graphtype = 'countgraph' if not args.small_count else \
        'smallcountgraph'
    report_on_config(args, graphtype=graphtype)
    check_valid_file_exists(args.input_filenames)
    check_space(args.input_filenames, args.force)
    if args.savegraph:
        graphsize = calculate_graphsize(args, graphtype)
        check_space_for_graph(args.savegraph, graphsize, args.force)

    if ('-' in args.input_filenames
            or '/dev/stdin' in args.input_filenames) and not args.output:
        log_error("Accepting input from stdin; output filename must "
                  "be provided with -o.")
        sys.exit(1)

    if args.loadgraph:
        log_info('loading countgraph from {graph}', graph=args.loadgraph)
        ct = load_countgraph(args.loadgraph, device=args.device,
                             small=args.small_count)
    else:
        log_info('making countgraph on {device}', device=args.device)
        ct = khmer_args.create_countgraph(args, device=args.device)

    K = ct.ksize()
    tempdir = tempfile.mkdtemp('khmer', 'tmp', args.tempdir)
    log_info('created temporary directory {temp};\n'
             'use -T to change location', temp=tempdir)

    trimmer = Trimmer(ct, not args.variable_coverage, args.cutoff,
                      args.trim_at_coverage)
    if args.diginorm:
        trimmer.set_diginorm(args.diginorm_coverage)

    # ### FIRST PASS ###

    written_bp = 0
    written_reads = 0

    if args.output:
        trimfp = get_file_writer(args.output, args.gzip, args.bzip)

    pass2list = []
    for filename in args.input_filenames:
        pass2filename = filename.replace(os.path.sep, '-') + '.pass2'
        pass2filename = os.path.join(tempdir, pass2filename)
        pass2fp = open(pass2filename, 'w')

        if args.output is None:
            outfp = open(os.path.basename(filename) + '.abundtrim', 'wb')
            trimfp = get_file_writer(outfp, args.gzip, args.bzip)

        pass2list.append((filename, pass2filename, trimfp))

        paired_iter = broken_paired_reader(ReadParser(filename),
                                           min_length=K,
                                           force_single=args.ignore_pairs)

        n_start = trimmer.n_reads
        save_start = trimmer.n_saved

        watermark = REPORT_EVERY_N_READS
        for read in trimmer.pass1(paired_iter, pass2fp):
            if (trimmer.n_reads - n_start) > watermark:
                log_info("... {filename} {n_saved} {n_reads} {n_bp} "
                         "{w_reads} {w_bp}", filename=filename,
                         n_saved=trimmer.n_saved,
                         n_reads=trimmer.n_reads,
                         n_bp=trimmer.n_bp, w_reads=written_reads,
                         w_bp=written_bp)
                watermark += REPORT_EVERY_N_READS
            write_record(read, trimfp)
            written_bp += len(read)
            written_reads += 1
        pass2fp.close()

        log_info("{filename}: kept aside {kept} of {total} from first "
                 "pass", filename=filename,
                 kept=trimmer.n_saved - save_start,
                 total=trimmer.n_reads - n_start)

    n_reads = trimmer.n_reads
    n_bp = trimmer.n_bp
    n_skipped = trimmer.n_skipped
    bp_skipped = trimmer.bp_skipped

    # ### SECOND PASS ###

    if not args.single_pass:
        for _, pass2filename, trimfp in pass2list:
            log_info('second pass: looking at sequences kept aside in '
                     '{pass2}', pass2=pass2filename)
            for read in trimmer.pass2(broken_paired_reader(
                    ReadParser(pass2filename), min_length=K,
                    force_single=args.ignore_pairs)):
                write_record(read, trimfp)
                written_reads += 1
                written_bp += len(read)
            log_info('removing {pass2}', pass2=pass2filename)
            os.unlink(pass2filename)

    log_info('removing temp directory & temp files')
    shutil.rmtree(tempdir)

    trimmed_reads = trimmer.trimmed_reads

    percent_reads_trimmed = float(trimmed_reads + (n_reads - written_reads)) \
        / n_reads * 100.0 if n_reads else 0.0

    log_info('read {read} reads, {bp} bp', read=n_reads, bp=n_bp)
    log_info('wrote {wr} reads, {wbp} bp', wr=written_reads,
             wbp=written_bp)
    if args.variable_coverage:
        log_info('{n} reads were high coverage ({p:.2f}%);',
                 n=n_reads - n_skipped,
                 p=((n_reads - n_skipped) / n_reads * 100.0
                    if n_reads else 0))
        log_info('skipped {n} reads/{bp} bases because of low coverage',
                 n=n_skipped, bp=bp_skipped)
    log_info('removed {r} reads and trimmed {t} reads ({p:.2f}%)',
             r=n_reads - written_reads, t=trimmed_reads,
             p=percent_reads_trimmed)

    fp_rate = calc_expected_collisions(ct, args.force, max_false_pos=.8)
    log_info('fp rate estimated to be {fpr:1.3f}', fpr=fp_rate)

    if args.output is None:
        log_info('output in *.abundtrim')
    elif args.output.name == 1:
        log_info('output streamed to stdout')
    elif args.output.name:
        log_info('output in {}'.format(args.output.name))

    if args.savegraph:
        log_info("Saving k-mer countgraph to {graph}",
                 graph=args.savegraph)
        ct.save(args.savegraph)

    if args.summary_info is not None:
        # mirror the reference's provenance record
        info = {'fpr': fp_rate,
                'reads': n_reads,
                'basepairs': n_bp,
                'reads_written': written_reads,
                'basepairs_written': written_bp,
                'reads_skipped': n_skipped,
                'basepairs_skipped': bp_skipped,
                'reads_removed': n_reads - written_reads,
                'reads_trimmed': trimmed_reads,
                'basepairs_removed_or_trimmed': n_bp - written_bp}
        store_provenance_info(info, fname=args.input_filenames[0],
                              format=args.summary_info)
    return trimmer


if __name__ == '__main__':
    main()
