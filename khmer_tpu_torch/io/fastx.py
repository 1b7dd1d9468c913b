"""FASTA/FASTQ reading and writing — a copy of khmer_tpu/io/fastx.py
(which cannot be imported without JAX).

Transparent gzip/bzip2 decompression is sniffed from magic bytes.
Sequence cleaning follows oxli::_to_valid_dna (read_parsers.cc:53-69):
acgt -> upper, other -> A. The native parser (io/native.py) reads file
paths; this module reads the rest and is the behavioral specification.
"""

import bz2
import gzip
import io
import os


class Record:
    """A sequence record (reference Read struct, read_parsers.hh:98-134)."""

    __slots__ = ("name", "sequence", "quality", "_cleaned_seq")

    def __init__(self, name="", sequence="", quality=None):
        self.name = name
        self.sequence = sequence
        self.quality = quality
        self._cleaned_seq = None

    @property
    def cleaned_seq(self):
        if self._cleaned_seq is None:
            self._cleaned_seq = clean_dna(self.sequence)
        return self._cleaned_seq

    @cleaned_seq.setter
    def cleaned_seq(self, value):
        self._cleaned_seq = value

    def __len__(self):
        return len(self.sequence)

    def __repr__(self):
        return "Record(name=%r, sequence=%r)" % (self.name, self.sequence)


_CLEAN_TABLE = bytearray(b"A" * 256)
for _c in b"ACGT":
    _CLEAN_TABLE[_c] = _c
for _c in b"acgt":
    _CLEAN_TABLE[_c] = _c - 32
_CLEAN_TABLE = bytes(_CLEAN_TABLE)

# script-level cleaning (khmer/utils.py:158-168) differs: upper, N->A only
_CLEAN_TABLE_SCRIPT = bytearray(range(256))
for _i in range(ord("a"), ord("z") + 1):
    _CLEAN_TABLE_SCRIPT[_i] = _i - 32
_CLEAN_TABLE_SCRIPT[ord("N")] = ord("A")
_CLEAN_TABLE_SCRIPT[ord("n")] = ord("A")
_CLEAN_TABLE_SCRIPT = bytes(_CLEAN_TABLE_SCRIPT)


def clean_dna(seq: str) -> str:
    """acgt -> ACGT, any other character -> A (oxli::_to_valid_dna)."""
    return seq.encode("ascii").translate(_CLEAN_TABLE).decode("ascii")


def clean_dna_script(seq: str) -> str:
    """upper() then N->A (khmer/utils.py clean_input_reads semantics)."""
    return seq.encode("ascii").translate(_CLEAN_TABLE_SCRIPT).decode("ascii")


def open_maybe_compressed(path):
    """Open a file for reading, decoding gzip/bzip2 from magic bytes."""
    if path in ("-", "/dev/stdin"):
        import sys
        raw = sys.stdin.buffer
        return _sniff_wrap(io.BufferedReader(_Unseekable(raw)))
    return _sniff_wrap(open(path, "rb"))


class _Unseekable(io.RawIOBase):
    def __init__(self, raw):
        self._raw = raw

    def readable(self):
        return True

    def readinto(self, b):
        data = self._raw.read(len(b))
        b[: len(data)] = data
        return len(data)


def _sniff_wrap(f):
    head = f.peek(3)[:3] if hasattr(f, "peek") else b""
    if head[:2] == b"\x1f\x8b":
        return gzip.open(f, "rb")
    if head[:3] == b"BZh":
        return bz2.open(f, "rb")
    return f


class FastxParser:
    """Iterate Records from a FASTA/FASTQ file (plain, .gz, or .bz2)."""

    def __init__(self, path):
        self.path = path
        self._fp = open_maybe_compressed(path)
        self._it = self._parse()
        self.num_reads = 0

    def _parse(self):
        fp = io.TextIOWrapper(io.BufferedReader(self._fp)
                              if not isinstance(self._fp, io.BufferedReader)
                              else self._fp)
        first = fp.readline()
        while first and not first.strip():
            first = fp.readline()
        if not first:
            return
        if first[0] == ">":
            # FASTA: multi-line sequences
            name = first[1:].rstrip("\n")
            chunks = []
            for line in fp:
                if line.startswith(">"):
                    yield self._make(name, "".join(chunks), None)
                    name = line[1:].rstrip("\n")
                    chunks = []
                else:
                    chunks.append(line.strip())
            yield self._make(name, "".join(chunks), None)
        elif first[0] == "@":
            # FASTQ: @name / seq lines / + / qual lines (len(qual)==len(seq))
            line = first
            while line:
                if not line.strip():
                    line = fp.readline()
                    continue
                if line[0] != "@":
                    raise ValueError(
                        "sequence and quality lengths differ, or invalid "
                        "FASTQ record near %r" % line[:40])
                name = line[1:].rstrip("\n")
                seq_chunks = []
                line = fp.readline()
                while line and line[0] != "+":
                    seq_chunks.append(line.strip())
                    line = fp.readline()
                if not line:
                    raise ValueError("truncated FASTQ record (no + line)")
                seq = "".join(seq_chunks)
                qual_chunks = []
                qlen = 0
                while qlen < len(seq):
                    line = fp.readline()
                    if not line:
                        break
                    qual_chunks.append(line.strip())
                    qlen += len(qual_chunks[-1])
                qual = "".join(qual_chunks)
                if len(qual) != len(seq):
                    raise ValueError(
                        "sequence and quality lengths differ for %r" % name)
                yield self._make(name, seq, qual)
                line = fp.readline()
        else:
            raise ValueError(
                "unknown sequence format; expected '>' or '@', got %r"
                % first[:20])

    def _make(self, name, seq, qual):
        self.num_reads += 1
        return Record(name=name, sequence=seq, quality=qual)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def close(self):
        self._fp.close()


def ReadParser(path, **kwargs):
    """khmer-compatible constructor name for a FastxParser; an empty file
    raises OSError, as the reference's parser does."""
    if os.path.exists(path) and os.path.getsize(path) == 0:
        raise OSError("file is empty: %s" % path)
    return FastxParser(path)


def write_record(record, fileobj):
    """Write a record in FASTA/FASTQ format (khmer/utils.py:120-135)."""
    if getattr(record, "quality", None) is not None:
        recstr = "@{name}\n{sequence}\n+\n{quality}\n".format(
            name=record.name, sequence=record.sequence,
            quality=record.quality)
    else:
        recstr = ">{name}\n{sequence}\n".format(
            name=record.name, sequence=record.sequence)
    try:
        fileobj.write(bytes(recstr, "ascii"))
    except TypeError:
        fileobj.write(recstr)
