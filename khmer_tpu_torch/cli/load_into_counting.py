#!/usr/bin/env python
"""Build a k-mer countgraph from the given sequences.

PyTorch port of khmer_tpu/cli/load_into_counting.py (reference
scripts/load-into-counting.py:107-217): the same flags and outputs
(.ct OXLI file, .info, optional .info.json/.info.tsv), plus --device.
Both layouts write the same .ct bytes as the JAX package: the default
--tpu-layout exact (OXLI type 1, with bigcount, loadable by khmer) and
--tpu-layout blocked.

% python -m khmer_tpu_torch.cli.load_into_counting <output.ct> <data1> \\
      [ <data2> <...> ]
"""

import json
import os
import textwrap

import khmer_tpu_torch
from khmer_tpu_torch import calc_expected_collisions
from khmer_tpu_torch.cli import args as khmer_args
from khmer_tpu_torch.cli.args import (add_threading_args,
                                      build_counting_args,
                                      calculate_graphsize, report_on_config,
                                      sanitize_help)
from khmer_tpu_torch.core.blocked import BlockedCountgraph
from khmer_tpu_torch.io.fastx import FastxParser
from khmer_tpu_torch.utils.kfile import (check_file_writable,
                                         check_input_files,
                                         check_space_for_graph)
from khmer_tpu_torch.utils.logger import configure_logging, log_info


def get_parser():
    epilog = """\
    Note: with :option:`-b`/:option:`--no-bigcount` the output will be the
    exact size of the k-mer countgraph and this script will use a constant
    amount of memory. In exchange k-mer counts will stop at 255. The memory
    usage of this script with :option:`-b` will be about 1.15x the product
    of the :option:`-x` and :option:`-N` numbers.

    Example::

        load-into-counting.py -k 20 -x 5e7 out data/100k-filtered.fa
    """
    parser = build_counting_args(
        "Build a k-mer countgraph from the given sequences.",
        epilog=textwrap.dedent(epilog), citations=['counting', 'SeqAn'])
    add_threading_args(parser)
    parser.add_argument('output_countgraph_filename', help="The name of the"
                        " file to write the k-mer countgraph to.")
    parser.add_argument('input_sequence_filename', nargs='+',
                        help="The names of one or more FAST[AQ] input "
                        "sequence files.")
    parser.add_argument('-b', '--no-bigcount', dest='bigcount',
                        default=True, action='store_false',
                        help="The default behaviour is to count past 255 "
                        "using bigcount. This flag turns bigcount off, "
                        "limiting counts to 255.")
    parser.add_argument('-s', '--summary-info', type=str, default=None,
                        metavar="FORMAT", choices=[str('json'), str('tsv')],
                        help="What format should the machine readable run "
                        "summary be in? (`json` or `tsv`, disabled by"
                        " default)")
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Overwrite output file if it exists')
    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    parser.add_argument('--tpu-layout', dest='tpu_layout',
                        choices=['exact', 'blocked'], default='exact',
                        help="Sketch layout: 'exact' is bit-compatible "
                        "with khmer's OXLI countgraphs; 'blocked' is the "
                        "128-byte-block layout (khmer_tpu-only file "
                        "format, no bigcount).")
    parser.add_argument('--device', default='cuda',
                        help="PyTorch device that holds the countgraph, "
                        "e.g. 'cuda', 'cuda:1' or 'cpu'.")
    return parser


def main(argv=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    configure_logging(args.quiet)
    report_on_config(args)

    base = args.output_countgraph_filename
    filenames = args.input_sequence_filename

    for name in args.input_sequence_filename:
        check_input_files(name, args.force)

    tablesize = calculate_graphsize(args, 'countgraph')
    check_space_for_graph(args.output_countgraph_filename, tablesize,
                          args.force)

    info_filename = base + ".info"
    check_file_writable(base)
    check_file_writable(info_filename)

    log_info('Saving k-mer countgraph to {base}', base=base)
    log_info('Loading kmers from sequences in {filenames}',
             filenames=repr(filenames))

    with open(info_filename, 'w') as info_fp:
        print('khmer version:', khmer_tpu_torch.__version__, file=info_fp)

    if args.tpu_layout == 'blocked':
        log_info('making blocked countgraph on {device}',
                 device=args.device)
        countgraph = BlockedCountgraph(args.ksize, tablesize, args.n_tables,
                                       device=args.device)
    else:
        log_info('making countgraph on {device}', device=args.device)
        countgraph = khmer_args.create_countgraph(args, device=args.device)

    total_num_reads = 0

    for index, filename in enumerate(filenames):
        rparser = FastxParser(filename)
        log_info('consuming input {input}', input=filename)
        countgraph.consume_seqfile(rparser)

        if index > 0 and index % 10 == 0:
            tablesize = calculate_graphsize(args, 'countgraph')
            check_space_for_graph(base, tablesize, args.force)
            log_info('mid-save {base}', base=base)
            countgraph.save(base)
        with open(info_filename, 'a') as info_fh:
            print('through', filename, file=info_fh)
        total_num_reads += rparser.num_reads

    n_kmers = countgraph.n_unique_kmers()
    log_info('Total number of unique k-mers: {nk}', nk=n_kmers)
    with open(info_filename, 'a') as info_fp:
        print('Total number of unique k-mers:', n_kmers, file=info_fp)

    log_info('saving {base}', base=base)
    countgraph.save(base)

    # Change max_false_pos=0.2 only if you really grok it. HINT: You don't
    fp_rate = calc_expected_collisions(countgraph, args.force,
                                       max_false_pos=.2)

    with open(info_filename, 'a') as info_fp:
        print('fp rate estimated to be %1.3f\n' % fp_rate, file=info_fp)

    if args.summary_info:
        mr_fmt = args.summary_info.lower()
        mr_file = base + '.info.' + mr_fmt
        log_info("Writing summmary info to {mr_file}", mr_file=mr_file)
        with open(mr_file, 'w') as mr_fh:
            if mr_fmt == 'json':
                mr_data = {
                    "ht_name": os.path.basename(base),
                    "fpr": fp_rate,
                    "num_kmers": n_kmers,
                    "files": filenames,
                    "mrinfo_version": "0.2.0",
                    "num_reads": total_num_reads,
                }
                json.dump(mr_data, mr_fh)
                mr_fh.write('\n')
            elif mr_fmt == 'tsv':
                mr_fh.write("ht_name\tfpr\tnum_kmers\tnum_reads\tfiles\n")
                vals = [
                    os.path.basename(base),
                    "{:1.3f}".format(fp_rate),
                    str(n_kmers),
                    str(total_num_reads),
                    ";".join(filenames),
                ]
                mr_fh.write("\t".join(vals) + "\n")

    log_info('fp rate estimated to be {fpr:1.3f}', fpr=fp_rate)

    log_info('DONE.')
    log_info('wrote to: {filename}', filename=info_filename)


if __name__ == '__main__':
    main()
