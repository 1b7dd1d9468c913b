"""File/space preflight checks and output writers (reference:
khmer/kfile.py); a copy of the parts of khmer_tpu/utils/kfile.py that the
CLIs use."""

import bz2
import errno
import gzip
import os
import sys
from stat import S_ISBLK, S_ISCHR, S_ISFIFO


def check_input_files(file_path, force):
    """Warn/exit on missing or empty input (fifos/stdin pass)."""
    mode = None
    if file_path == "-":
        return
    try:
        mode = os.stat(file_path).st_mode
    except OSError:
        print("ERROR: Input file %s does not exist" % file_path,
              file=sys.stderr)
        if not force:
            print("NOTE: This can be overridden using the --force argument",
                  file=sys.stderr)
            print("Exiting", file=sys.stderr)
            sys.exit(1)
        else:
            return

    if S_ISBLK(mode) or S_ISFIFO(mode) or S_ISCHR(mode):
        return

    if not os.path.exists(file_path):
        print("ERROR: Input file %s does not exist; exiting" % file_path,
              file=sys.stderr)
        if not force:
            print("NOTE: This can be overridden using the --force argument",
                  file=sys.stderr)
            sys.exit(1)
    else:
        if os.stat(file_path).st_size == 0:
            print("ERROR: Input file %s is empty; exiting." % file_path,
                  file=sys.stderr)
            if not force:
                print("NOTE: This can be overridden using the --force"
                      " argument", file=sys.stderr)
                sys.exit(1)


def check_file_writable(file_path):
    try:
        file_obj = open(file_path, "a")
    except IOError as error:
        if error.errno == errno.EACCES:
            print("ERROR: File %s does not have write " % file_path
                  + "permission; exiting", file=sys.stderr)
            sys.exit(1)
        else:
            print("ERROR: " + error.strerror, file=sys.stderr)
    else:
        file_obj.close()
        return


def check_space(in_files, force):
    """Check that the disk of the first input has room for outputs as
    large as the inputs together."""
    in_file = in_files[0]
    dir_path = os.path.dirname(os.path.realpath(in_file))
    target = os.statvfs(dir_path)
    free_space = target.f_frsize * target.f_bavail
    valid_files = [f for f in in_files if os.path.isfile(f)]
    total_size = sum(os.stat(f).st_size for f in valid_files)
    size_diff = total_size - free_space
    if size_diff > 0:
        # message structure mirrors reference khmer/kfile.py:136-149
        message = ("Not enough free space on disk for output files;"
                   "\n       Need at least {:.1f} GB more."
                   "\n       Estimated Output size: {:.1f} GB"
                   "\n       Free space: {:.1f} GB").format(
                       size_diff / 1e9, total_size / 1e9, free_space / 1e9)
        if force:
            print("WARNING:", message, file=sys.stderr)
        else:
            raise SystemExit(
                "ERROR: " + message + "\nNOTE: This can be overridden "
                "using the --force argument")


def check_space_for_graph(outfile_name, graph_size, force,
                          _testhook_free_space=None):
    """Check that we have enough size to write the specified graph."""
    dir_path = os.path.dirname(os.path.realpath(outfile_name))
    target = os.statvfs(dir_path)
    if _testhook_free_space is None:
        free_space = target.f_frsize * target.f_bavail
    else:
        free_space = _testhook_free_space
    size_diff = graph_size - free_space
    if size_diff > 0:
        # message structure mirrors reference khmer/kfile.py:169-182
        message = ("Not enough free space on disk for saved graph files;"
                   "\n       Need at least {:.1f} GB more."
                   "\n       Table size: {:.1f} GB"
                   "\n       Free space: {:.1f} GB").format(
                       size_diff / 1e9, graph_size / 1e9, free_space / 1e9)
        if force:
            print("WARNING:", message, file=sys.stderr)
        else:
            raise SystemExit(
                "ERROR: " + message + "\nNOTE: This can be overridden "
                "using the --force argument")


def check_valid_file_exists(in_files):
    """Warn (only) about empty/missing inputs; '-' (stdin) passes.

    Mirrors the reference exactly (khmer/kfile.py:185-203): this check
    never exits — scripts that require a usable input fail later with
    their own error, and streaming '-' inputs must reach the scripts'
    stdin handling.
    """
    for in_file in in_files:
        if in_file == "-":
            pass
        elif os.path.exists(in_file):
            mode = os.stat(in_file).st_mode
            if os.stat(in_file).st_size > 0 or S_ISBLK(mode) \
                    or S_ISFIFO(mode):
                return
            else:
                print("WARNING: Input file %s is empty" % in_file,
                      file=sys.stderr)
        else:
            print("WARNING: Input file %s not found" % in_file,
                  file=sys.stderr)


def add_output_compression_type(parser):
    parser.add_argument("--gzip", default=False, action="store_true",
                        help="Compress output using gzip")
    parser.add_argument("--bzip", default=False, action="store_true",
                        help="Compress output using bzip2")


def get_file_writer(file_handle, do_gzip, do_bzip):
    ofile = None
    if do_gzip and do_bzip:
        raise ValueError("Cannot specify both bzip and gzip compression!")
    elif do_gzip:
        ofile = gzip.GzipFile(fileobj=file_handle, mode="w")
    elif do_bzip:
        ofile = bz2.open(file_handle, "w")
    else:
        ofile = file_handle
    return ofile


def is_block(fthing):
    """Whether a file handle (or path) is a block/char device or stdio.

    Mirrors reference khmer/kfile.py:208-214: handles that ARE
    stdout/stdin (or their binary buffers) count as block devices.
    """
    if fthing in ("-",):
        return True
    if fthing is sys.stdout or fthing is sys.stdin:
        return True
    if (fthing is getattr(sys.stdout, "buffer", None)
            or fthing is getattr(sys.stdin, "buffer", None)):
        return True
    name = fthing if isinstance(fthing, str) else getattr(
        fthing, "name", None)
    if not isinstance(name, str):
        return False
    try:
        mode = os.stat(name).st_mode
        # reference khmer/kfile.py:208-214 checks block OR char device
        return S_ISBLK(mode) or S_ISCHR(mode)
    except OSError:
        return False


def describe_file_handle(handle):
    """Name of a file handle, or "block device" for stdio/devices
    (reference khmer/kfile.py:217-222)."""
    if is_block(handle):
        return "block device"
    if hasattr(handle, "name"):
        return handle.name
    return str(handle)
