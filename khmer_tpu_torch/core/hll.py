"""HyperLogLog++ cardinality estimator — counterpart of
khmer_tpu/core/hll.py (reference src/oxli/hllcounter.cc).

The 2^p u8 registers live on the counter's device ("cuda" unless the
caller asks for another; no CPU fallback). A flat chunk of reads goes to
the registers in one launch of kernel K (sketch_kernels.hll_add):
canonical murmur of every valid k-window and the register max, fused.
Files take the native packer's blocks, each one flat chunk; a record
stream (--stream-records, parsers) goes through the FlatPacker. The
estimate reads the registers back to the host and applies the bias
correction (Heule et al., dx.doi.org/10.1145/2452376.2452456) with the
constants of core/data/hll_bias.npz, a copy of the JAX package's.
"""

import functools
import math
import os

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.ops import hashing as H
from khmer_tpu_torch.ops.u64 import to_signed


@functools.cache
def _bias_data():
    path = os.path.join(os.path.dirname(__file__), "data", "hll_bias.npz")
    with np.load(path) as data:
        return {name: data[name] for name in data.files}


def get_threshold(p):
    return int(_bias_data()["thresholds"][p - 4])


def estimate_bias(E, p):
    """Average bias of the 6 nearest raw-estimate neighbors
    (hllcounter.cc:145-175)."""
    data = _bias_data()
    raw = data["raw_%d" % p]
    bias = data["bias_%d" % p]
    dist = (E - raw) ** 2
    order = np.lexsort((np.arange(len(raw)), dist))
    nearest = order[:6]
    return float(bias[nearest].mean())


def calc_alpha(nc):
    if nc < 16:
        raise ValueError(
            "You need at least 16 counters to use HyperLogLog. "
            "Please, set a smaller error rate (try 0.36 or above).")
    p = int(math.floor(math.log2(nc)))
    if p == 4:
        return 0.673
    if p == 5:
        return 0.697
    if p == 6:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / (1 << p))


def _p_of(error_rate):
    if error_rate < 0:
        raise ValueError("Please set error rate to a value "
                         "greater than zero")
    return math.ceil(math.log2((1.04 / error_rate) ** 2))


class HLLCounter:
    """khmer-compatible HLLCounter, its registers on `device`."""

    def __init__(self, error_rate, ksize, *, device="cuda"):
        from khmer_tpu_torch.core.sketch import _resolve_device

        self.device = _resolve_device(device)
        if isinstance(error_rate, float):
            nc = 1 << _p_of(error_rate)
        else:
            nc = int(error_rate)
        self._init(nc, ksize)

    def _init(self, nc, ksize):
        self._alpha = calc_alpha(nc)
        self.ncounters_log2 = int(math.floor(math.log2(nc)))
        self.ncounters = nc
        self._ksize = int(ksize)
        self._registers = torch.zeros(nc, dtype=torch.uint8,
                                      device=self.device)
        self._touched = False

    # -- properties mirroring the Cython wrapper --------------------------

    @property
    def alpha(self):
        """Bias-correction constant (read-only, hllcounter.hh)."""
        return self._alpha

    @property
    def counters(self):
        return [int(c) for c in self._registers.cpu().numpy()]

    @property
    def error_rate(self):
        return 1.04 / math.sqrt(self.ncounters)

    @error_rate.setter
    def error_rate(self, error_rate):
        if self._touched:
            raise AttributeError("You can only change error rate prior to "
                                 "first counting")
        self._init(1 << _p_of(error_rate), self._ksize)

    @property
    def ksize(self):
        return self._ksize

    @ksize.setter
    def ksize(self, k):
        if self._touched:
            raise AttributeError("You can only change k-mer size prior to "
                                 "first counting")
        if k < 1:
            raise ValueError("Please set k-mer size to a value "
                             "greater than zero")
        self._ksize = int(k)

    def __len__(self):
        return self.estimate_cardinality()

    # -- counting ---------------------------------------------------------

    def add(self, kmer):
        """Add one k-mer string (hashed as given, on the host)."""
        self._touched = True
        h = torch.tensor([to_signed(H.hash_murmur3(kmer))],
                         dtype=torch.int64)
        index, rho = K.hll_index_rho(h, self.ncounters_log2)
        i = int(index[0])
        reg = self._registers[i:i + 1]
        torch.clamp_(reg, min=int(rho[0]))

    def _add_chunk(self, codes, starts, fill):
        """Kernel K (on the card) over one flat chunk held in numpy."""
        self._touched = True
        if fill < self._ksize:
            return
        dev = self.device
        K.hll_add(self._registers,
                  torch.from_numpy(np.ascontiguousarray(
                      codes[:fill], dtype=np.uint8)).to(dev),
                  torch.from_numpy(np.ascontiguousarray(
                      starts, dtype=np.int64)).to(dev),
                  fill, self._ksize)

    def consume_string(self, seq):
        """Count all k-mers; returns number consumed."""
        if len(seq) < self._ksize:
            raise ValueError("string length must >= the counter k-mer size")
        codes = H.encode_dna(seq)
        self._add_chunk(codes, np.zeros(1, np.int64), len(codes))
        return len(codes) - self._ksize + 1

    def consume_seqfile(self, source, stream_records=False):
        """Returns (total_reads, n_consumed).

        A file path goes through the native packer, one flat chunk a
        block; with stream_records, or for a parser or record iterable,
        the records go through the FlatPacker (each is written to stdout
        first when stream_records is set)."""
        import sys

        from khmer_tpu_torch.core import pipeline
        from khmer_tpu_torch.io import native
        from khmer_tpu_torch.io.fastx import write_record

        k = self._ksize
        self._touched = True
        total_reads = 0
        n_consumed = 0
        if isinstance(source, str) and not stream_records:
            for codes, meta, _ in native.pack_blocks(source):
                total_reads += len(meta)
                n_consumed += int(np.maximum(meta[:, 1] - k + 1, 0).sum())
                self._add_chunk(codes, meta[:, 0], len(codes))
            return total_reads, n_consumed

        packer = pipeline.FlatPacker(k)

        def commit(chunks):
            nonlocal n_consumed
            for codes, starts, nfill in chunks:
                n_consumed += K.flat_valid_windows(starts, nfill, k)
                self._add_chunk(codes, starts, nfill)

        for record in pipeline.records_from(source):
            if stream_records:
                write_record(record, sys.stdout)
            seq = record.cleaned_seq
            total_reads += 1
            if len(seq) >= k:
                commit(packer.add(seq))
        tail = packer.flush()
        if tail is not None:
            commit([tail])
        return total_reads, n_consumed

    consume_seqfile_with_reads_parser = consume_seqfile

    # -- estimation --------------------------------------------------------

    def estimate_cardinality(self):
        """HLL++ estimate (hllcounter.cc:237-260)."""
        counters = self._registers.cpu().numpy()
        V = int((counters == 0).sum())
        nc = self.ncounters
        if V > 0:
            Hlin = nc * math.log(nc / V)
            if Hlin <= get_threshold(self.ncounters_log2):
                return int(Hlin)
        s = float(np.power(2.0, -counters.astype(np.float64)).sum())
        E = self._alpha * nc * nc / s
        if E <= 5 * nc:
            return int(E - estimate_bias(E, self.ncounters_log2))
        return int(E)

    def merge(self, other):
        if (self.ncounters != other.ncounters
                or self._ksize != other._ksize):
            raise ValueError("HLLCounters to be merged must be created "
                             "with same parameters")
        torch.maximum(self._registers,
                      other._registers.to(self.device),
                      out=self._registers)
