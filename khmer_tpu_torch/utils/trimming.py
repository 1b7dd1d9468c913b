"""Read trimming helpers (reference: khmer/trimming.py:38-67) — a copy of
khmer_tpu/utils/trimming.py on the port's Record."""

from khmer_tpu_torch.io.fastx import Record


def trim_record(countgraph, record, cutoff, variable_coverage=False,
                normalize_to=None):
    """Trim one record at low-abundance k-mers.

    Returns (trimmed_record_or_None, did_trim).
    """
    seqN = record.cleaned_seq

    if variable_coverage:  # only trim when sequence has high enough C
        if not countgraph.median_at_least(seqN, normalize_to):
            return record, False

    _, trim_at = countgraph.trim_on_abundance(seqN, cutoff)
    return _apply_trim(countgraph.ksize(), record, trim_at)


def _apply_trim(ksize, record, trim_at):
    seq = record.sequence
    if trim_at < ksize:
        return None, True
    if trim_at == len(seq):
        return record, False
    trim_seq = seq[:trim_at]
    if getattr(record, "quality", None) is not None:
        return Record(name=record.name, sequence=trim_seq,
                      quality=record.quality[:trim_at]), True
    return Record(name=record.name, sequence=trim_seq), True


def trim_pos_from_counts(counts, ksize, cutoff, seq_len, below=False):
    """First trim position given the per-window count array: at the first
    window below `cutoff` (`below`: above it, trim_below_abundance).

    Mirrors Hashtable::trim_on_abundance (hashtable.cc:504-533):
    sequences with a single window always return 0.
    """
    import numpy as np

    n = len(counts)
    if n == 0:
        return 0
    counts = np.asarray(counts)
    bad = (counts > cutoff) if below else (counts < cutoff)
    if n == 1 or bad[0]:
        return 0
    bad = np.nonzero(bad[1:])[0]
    if bad.size:
        return int(ksize + bad[0])
    return seq_len


def median_at_least_from_counts(counts, ksize, cutoff, seq_len):
    min_req = int(0.5 + (seq_len - ksize + 1) / 2.0)
    return int((counts >= cutoff).sum()) >= min_req
