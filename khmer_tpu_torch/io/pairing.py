"""Paired-read utilities mirroring khmer's pairing semantics; a copy of
khmer_tpu/io/pairing.py (importing it would import JAX).

References: khmer/_oxli/parsing.pyx:380-540 (check_is_pair),
khmer/utils.py:48-117 (broken_paired_reader).
"""


class UnpairedReadsError(ValueError):
    """Raised when a stream is not interleaved but pairing was required."""

    def __init__(self, msg, r1, r2):
        r1_name = "<no read>"
        r2_name = "<no read>"
        if r1:
            r1_name = r1.name
        if r2:
            r2_name = r2.name
        super().__init__(msg + " Specifically, %s and %s" %
                         (r1_name, r2_name))
        self.read1 = r1
        self.read2 = r2


def _split_left_right(name):
    """Split record name at the first whitespace; ('' rhs if absent)."""
    lhs = ""
    rhs = ""
    for i, c in enumerate(name):
        if c in " \t":
            lhs = name[:i]
            rhs = name[i + 1:]
            break
    if lhs == "":
        lhs = name
    return lhs, rhs


def check_is_pair(first, second):
    """Check whether two records form a read pair.

    Handles 'name/1' + 'name/2', Casava 1.8 'name 1:...' + 'name 2:...',
    and SRA 'acc name/1' styles.
    """
    if ((getattr(first, "quality", None) is None)
            != (getattr(second, "quality", None) is None)):
        raise ValueError("both records must be same type (FASTA or FASTQ)")

    lhs1, rhs1 = _split_left_right(first.name)
    lhs2, rhs2 = _split_left_right(second.name)

    # handle 'name/1'
    if lhs1.endswith("/1") and lhs2.endswith("/2"):
        subpart1 = lhs1.split("/", 1)[0]
        subpart2 = lhs2.split("/", 1)[0]
        if subpart1 and subpart1 == subpart2:
            return True
    # handle '@name 1:rst'
    elif lhs1 == lhs2 and rhs1.startswith("1:") and rhs2.startswith("2:"):
        return True
    # handle '@name seq/1'
    elif lhs1 == lhs2 and rhs1.endswith("/1") and rhs2.endswith("/2"):
        subpart1 = rhs1.split("/", 1)[0]
        subpart2 = rhs2.split("/", 1)[0]
        if subpart1 and subpart1 == subpart2:
            return True
    return False


def broken_paired_reader(screed_iter, min_length=None, force_single=False,
                         require_paired=False):
    """Yield (n, is_pair, r1, r2) over a possibly-paired record stream.

    Matches khmer/utils.py:48-117 exactly, including the record-count
    numbering and short-read filtering rules.
    """
    record = None
    prev_record = None
    num = 0

    if force_single and require_paired:
        raise ValueError("force_single and require_paired cannot both "
                         "be set!")

    for record in screed_iter:
        if prev_record:
            if check_is_pair(prev_record, record) and not force_single:
                if min_length and (len(prev_record.sequence) < min_length
                                   or len(record.sequence) < min_length):
                    if require_paired:
                        record = None
                else:
                    yield num, True, prev_record, record
                    num += 2
                    record = None
            else:  # orphan
                if require_paired:
                    raise UnpairedReadsError(
                        "Unpaired reads when require_paired is set!",
                        prev_record, record)
                if min_length and len(prev_record.sequence) < min_length:
                    pass
                else:
                    yield num, False, prev_record, None
                    num += 1
        prev_record = record
        record = None

    if prev_record:
        if require_paired:
            raise UnpairedReadsError(
                "Unpaired reads when require_paired is set!",
                prev_record, None)
        if min_length and len(prev_record.sequence) < min_length:
            pass
        else:
            yield num, False, prev_record, None


def clean_input_reads(records):
    """Attach script-style cleaned_seq (khmer/utils.py:158-168)."""
    from khmer_tpu_torch.io.fastx import clean_dna_script

    for record in records:
        record.cleaned_seq = clean_dna_script(record.sequence)
        yield record

