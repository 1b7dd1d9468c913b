"""Seeded synthetic reads for normalize-by-median at a table size users run.

A random genome, reads of fixed length at uniform starts on it, half of
them reverse-complemented, with uniform substitutions, written as FASTA
(">r<i>" names, one sequence line): 1,000,000 reads of 100 bp on a
2,000,000-base genome (50x coverage), 1% substitutions, from numpy's
default_rng(2026); every run writes the same bytes.

    python -m khmer_tpu_torch.scripts.synth_reads out.fa
"""

import argparse

import numpy as np

_LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)
SEED = 2026
GENOME_LEN = 2_000_000
N_READS = 1_000_000
READ_LEN = 100
SUB_RATE = 0.01
_CHUNK = 100_000  # reads drawn at a time (part of what fixes the bytes)


def write_reads(path):
    """Write the reads to `path`."""
    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, GENOME_LEN, dtype=np.uint8)
    span = np.arange(READ_LEN)
    with open(path, "wb") as f:
        for lo in range(0, N_READS, _CHUNK):
            n = min(_CHUNK, N_READS - lo)
            starts = rng.integers(0, GENOME_LEN - READ_LEN + 1, n)
            reads = genome[starts[:, None] + span]
            rc = rng.random(n) < 0.5
            reads[rc] = 3 - reads[rc][:, ::-1]
            sub = rng.random((n, READ_LEN), dtype=np.float32) < SUB_RATE
            shift = rng.integers(1, 4, (n, READ_LEN), dtype=np.uint8)
            reads = np.where(sub, (reads + shift) % 4, reads)
            seqs = _LETTERS[reads]
            f.write(b"".join(b">r%d\n%s\n" % (lo + i, seqs[i].tobytes())
                             for i in range(n)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("output")
    write_reads(parser.parse_args(argv).output)


if __name__ == "__main__":
    main()
