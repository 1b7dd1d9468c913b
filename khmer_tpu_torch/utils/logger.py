"""Quiet-aware stderr logging (reference: khmer/khmer_logger.py); a copy
of the parts of khmer_tpu/utils/logger.py that the CLIs use."""

import sys

__QUIET__ = False


def configure_logging(quiet):
    global __QUIET__
    __QUIET__ = quiet


def log_info(message, **kwargs):
    if not __QUIET__:
        if kwargs:
            message = message.format(**kwargs)
        print(message, file=sys.stderr)


def log_warn(message, **kwargs):
    if kwargs:
        message = message.format(**kwargs)
    print(message, file=sys.stderr)


def log_error(message, **kwargs):
    if kwargs:
        message = message.format(**kwargs)
    print(message, file=sys.stderr)


def print_error(msg):
    print(msg, file=sys.stderr)
