"""Digital normalization on the card: the median test and the sequential
keep/consume scan of a window of read bundles — counterpart of
khmer_tpu/core/diginorm_scan.py.

The keep/discard decision is sequential: every kept bundle's k-mers
update the countgraph and change later medians (reference
scripts/normalize-by-median.py:155-179). Per window of bundles (at most
two reads each):

- phase A (kernel E, sketch_kernels.diginorm_med): the median test of
  every bundle under the tables as the window found them. Counts only
  grow, so a bundle rejected here stays rejected. The kernel loads table
  0 first and the other tables only where that leaves a bundle undecided
  (sketch_kernels.med_load_plan);
- phase B (kernel F, sketch_kernels.diginorm_scan): one launch walks the
  other bundles, the keep candidates, in stream order: gather the counts,
  test median_at_least(C) (hashtable.cc:333), and if the bundle is kept,
  add its k-mers to the u8 tables in place, saturating, with n_unique
  exact (some counter 0 when the k-mer came). The kernel gathers a group
  of candidates' counters at once and runs the group's tests and adds on
  a copy in shared memory (sketch_kernels.scan_groups).

The JAX engine keeps u32 copies of the u8 tables because XLA has no
saturating u8 scatter; the kernels add to the u8 tables themselves, so the
countgraph costs its own size and no more, and finalize() has nothing to
copy back. The host reads the keep flags once per window. The plain
versions of both phases (sketch_kernels.med_ok_plain,
diginorm_window_plain) run for a countgraph on the CPU.

The kernels take rows of any length. A window is packed at the ladder
length of its longest read, except that bundles holding a read longer than
pipeline.MAX_ROW_LEN go in runs of their own (row_runs), so one long read
does not pad the whole window; the runs go through both phases in stream
order, which changes no decision.
"""

import itertools

import numpy as np
import torch

from khmer_tpu_torch.core import pipeline
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.sketch_kernels import (  # noqa: F401
    diginorm_window_plain, med_ok_plain)
from khmer_tpu_torch.ops.hashing import ASCII_TO_CODE

MAX_KCOUNT = K.MAX_KCOUNT


def pack_window(bundles, L):
    """(codes uint8 [2n, L], lengths int32 [2n]) of n bundles: read j of
    bundle i (j < 2) in row 2i + j as cleaned 2-bit codes, zero-padded;
    absent reads have length 0."""
    rows, seqs = [], []
    for i, bundle in enumerate(bundles):
        for j, rec in enumerate(bundle[:2]):
            rows.append(2 * i + j)
            seqs.append(rec.cleaned_seq)
    return _pack(rows, seqs, 2 * len(bundles), L)


def pack_reads(seqs, L):
    """(codes uint8 [n, L], lengths int32 [n]) of n cleaned sequences, one
    a row, zero-padded."""
    return _pack(range(len(seqs)), seqs, len(seqs), L)


def _pack(rows, seqs, nrows, L):
    """Sequence i in row rows[i], the rows ascending: the joined codes fill
    each row's first length cells in row-major order."""
    lengths = np.zeros(nrows, dtype=np.int32)
    lengths[np.asarray(rows, dtype=np.int64)] = [len(s) for s in seqs]
    codes = np.zeros((nrows, L), dtype=np.uint8)
    if seqs:
        codes[np.arange(L)[None, :] < lengths[:, None]] = ASCII_TO_CODE[
            np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8)]
    return codes, lengths


# padded codes a run of bundles holding reads longer than MAX_ROW_LEN
# packs at once
LONG_RUN_BYTES = 1 << 24


def row_runs(bundles, k):
    """Split a window into consecutive runs, each packed at one row length:
    [(start, stop, L)]. Bundles whose reads fit pipeline.MAX_ROW_LEN run
    together at the ladder length of their longest read (at least k + 7),
    as the whole window does when it holds no longer read; the others run
    at the length of their longest read, as many together as keep the
    run's padded codes, 2 (stop - start) L bytes, within LONG_RUN_BYTES
    (a single bundle always runs)."""
    lens = [max((len(r.cleaned_seq) for r in b[:2]), default=0)
            for b in bundles]
    runs, start = [], 0
    for long, group in itertools.groupby(
            lens, lambda n: n > pipeline.MAX_ROW_LEN):
        group = list(group)
        stop = start + len(group)
        if not long:
            runs.append((start, stop,
                         max(pipeline._bucket_len(max(group)), k + 7)))
        else:
            s, L = start, 0
            for i, n in enumerate(group, start):
                if i > s and 2 * (i + 1 - s) * max(L, n) > LONG_RUN_BYTES:
                    runs.append((s, i, L))
                    s, L = i, 0
                L = max(L, n)
            runs.append((s, stop, L))
        start = stop
    return runs


class ScanNormalizer:
    """Window-batched, device-sequential exact diginorm engine."""

    def __init__(self, countgraph, desired_coverage):
        if countgraph.storage_kind != "byte":
            raise ValueError("ScanNormalizer requires byte storage; use "
                             "BatchedNormalizer for other kinds")
        self.graph = countgraph
        self.C = int(desired_coverage)
        self.k = countgraph.ksize()
        self._primes = tuple(countgraph._primes)
        # what the scan did: the runs it scanned (one a window unless reads
        # longer than MAX_ROW_LEN split it), the valid k-windows phase A
        # tested, the counters kernel E loaded for them (med_load_plan's
        # rule), the bundles phase B tested and the groups kernel F took
        # them in (counters on the sketch's device but med_windows)
        self.scan_runs = 0
        self.med_windows = 0
        dev = countgraph.device
        self.med_loads = torch.zeros(1, dtype=torch.int64, device=dev)
        self.candidates = torch.zeros(1, dtype=torch.int64, device=dev)
        self.groups = torch.zeros(1, dtype=torch.int64, device=dev)

    def process_window(self, bundles):
        """bundles: list of record lists (1 or 2 reads), as many as the
        caller wants a window to hold. Returns kept records per bundle,
        exactly as the sequential reference."""
        out = [[] for _ in bundles]
        for start, stop, L in row_runs(bundles, self.k):
            keep = self._scan(bundles[start:stop], L)
            for i in np.nonzero(keep)[0]:
                out[start + i] = list(bundles[start + i])
        return out

    def _scan(self, bundles, L):
        """Phases A and B of one run at rows of L codes -> keep, bool
        numpy [n]."""
        codes, lengths = pack_window(bundles, L)
        self.med_windows += int(np.maximum(
            lengths.astype(np.int64) - (self.k - 1), 0).sum())
        dev = self.graph.device
        codes = torch.from_numpy(codes).to(dev)
        lengths = torch.from_numpy(lengths).to(dev)
        rejected = self._phase_a(codes, lengths)
        keep = K.diginorm_scan(self._primes, self.k, self.C,
                               self.graph.tables.flat, self.graph._n_unique,
                               codes, lengths, rejected, self.candidates,
                               self.groups)
        self.scan_runs += 1
        return keep.cpu().numpy()

    def _phase_a(self, codes, lengths):
        return K.diginorm_med(self._primes, self.k, self.C,
                              self.graph.tables.flat, codes, lengths,
                              self.med_loads)

    def finalize(self):
        """Nothing to write back: the scan updated the countgraph's own
        tables and unique count (interface parity with the JAX engine)."""


class ScanTrimmerState:
    """trim-low-abund's pass 1 on the sketch's device, a window of bundles
    at a time — counterpart of khmer_tpu/core/diginorm_scan.py:238.

    Per bundle, in stream order (reference scripts/trim-low-abund.py
    :190-238): branch 0 (--diginorm: every present read at digi_cov) drops
    the bundle, branch 1 (every present read at trim_cov) emits it trimmed
    at trim_at, branch 2 consumes its k-mers, which later bundles see, and
    saves it for pass 2. Kernel G (sketch_kernels.trim_scan; its plain
    versions for a countgraph on the CPU) decides a run and adds to the u8
    tables in place, in three launches: the pre-pass's mark and probe
    settle, against the tables as the run starts, every bundle no add of
    the run can change, and the walk runs the rest, the live bundles, in
    stream order. The host reads the branches and trim positions once a
    run. Runs are row_runs', as ScanNormalizer packs them, so reads longer
    than pipeline.MAX_ROW_LEN need no host window."""

    def __init__(self, graph, cutoff, trim_cov, digi_cov=None):
        if graph.storage_kind != "byte":
            raise ValueError("scan trimmer requires byte storage")
        self.graph = graph
        self.k = graph.ksize()
        self.cutoff = int(cutoff)
        self.trim_cov = int(trim_cov)
        self.digi_cov = None if digi_cov is None else int(digi_cov)
        self._primes = tuple(graph._primes)
        # what the scan did: the runs it scanned (one a window unless reads
        # longer than MAX_ROW_LEN split it), their bundles, and on the
        # sketch's device the candidates, the live bundles the walk took
        # and the groups it took them in
        self.scan_runs = 0
        self.bundles = 0
        dev = graph.device
        self.candidates = torch.zeros(1, dtype=torch.int64, device=dev)
        self.live = torch.zeros(1, dtype=torch.int64, device=dev)
        self.groups = torch.zeros(1, dtype=torch.int64, device=dev)

    def process_window(self, bundles):
        """bundles: list of record lists (1 or 2 reads). Returns (branch
        int32 [n], trim_at int32 [n, 2]) numpy arrays, exactly as the
        sequential reference decides."""
        n = len(bundles)
        self.bundles += n
        out = np.zeros((n, 3), dtype=np.int32)
        dev = self.graph.device
        for start, stop, L in row_runs(bundles, self.k):
            codes, lengths = pack_window(bundles[start:stop], L)
            branch, trim_at = K.trim_scan(
                self._primes, self.k, self.cutoff, self.trim_cov,
                self.digi_cov, self.graph.tables.flat, self.graph._n_unique,
                torch.from_numpy(codes).to(dev),
                torch.from_numpy(lengths).to(dev), self.candidates,
                self.live, self.groups)
            out[start:stop] = torch.cat([branch[:, None], trim_at],
                                        dim=1).cpu().numpy()
            self.scan_runs += 1
        return out[:, 0], out[:, 1:]

    def finalize(self):
        """Nothing to write back: the scan updated the countgraph's own
        tables and unique count (interface parity with the JAX engine)."""

    def reload(self):
        """Nothing to re-read: the countgraph's tables are the scan's."""


def read_counts_window(graph, records, cutoff, at_least, big=None):
    """Kernel H (sketch_kernels.read_counts) over a window of records, read
    only: (trim_at int32 [n], n_ge int32 [n]) numpy arrays, each record's
    trim position under `cutoff` (utils/trimming.py trim_pos_from_counts of
    its counts) and its windows at or above `at_least`; with `big`
    (sketch_kernels.bigcount_table of the countgraph's map), counts of 255
    read through the map. One launch and one host read a run of row_runs,
    one record a row."""
    out = np.zeros((len(records), 2), dtype=np.int32)
    k = graph.ksize()
    dev = graph.device
    for start, stop, L in row_runs([[r] for r in records], k):
        codes, lengths = pack_reads(
            [r.cleaned_seq for r in records[start:stop]], L)
        trim_at, n_ge = K.read_counts(
            tuple(graph._primes), k, cutoff, at_least, graph.tables.flat,
            torch.from_numpy(codes).to(dev),
            torch.from_numpy(lengths).to(dev), big)
        out[start:stop] = torch.stack([trim_at, n_ge],
                                      dim=1).cpu().numpy()
    return out[:, 0], out[:, 1]
