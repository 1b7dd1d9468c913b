"""Digital normalization, window-batched and sequential-exact, on any
sketch — counterpart of khmer_tpu/core/diginorm.py.

The reference algorithm (scripts/normalize-by-median.py:155-179) is
strictly sequential: each consumed read updates the countgraph, changing
later decisions. This engine restores exactness per *window* of read
bundles:

  1. one device pass hashes every read in the window and gathers its
     *per-table* counter values from the current sketch
     (make_pertable_counts);
  2. a host pass walks bundles in stream order, keeping a delta map of
     (table, counter) -> adds committed within this window; each read's
     effective count is min_t(saturate(base_t + delta_t)), which equals
     what the sequential reference would see;
  3. consumed reads' hashes are committed to the sketch in stream order
     in one batched update at window end (n_unique and bigcount stay
     exact).

On byte tables the kernels run the whole scan instead
(core/diginorm_scan.py ScanNormalizer, which the normalize-by-median CLI
uses); this engine serves the other storage kinds (a SmallCountgraph's
nibble tables: kernel R's rows mode hashes the window's codes and gathers
its valid windows' counters, kernel P commits its consumes) and is the
tests' second reference.
"""

import numpy as np
import torch

from khmer_tpu_torch.core import pipeline
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.diginorm_scan import pack_reads
from khmer_tpu_torch.ops import hashing as H
from khmer_tpu_torch.ops.u64 import umod

MAX_KCOUNT = K.MAX_KCOUNT


def make_pertable_counts(kind, primes, k, hash_family):
    """fn(tables, codes [B, L], lengths [B]) -> (hashes [B, W] int64,
    per-table counter values [T, B, W], valid [B, W] bool), on the tables'
    device, on every window as JAX's function gives them (SeqWindow reads
    only the valid ones, and on nibble tables takes kernel R's rows mode,
    which loads nothing past a read's end). Nibble tables take the
    per-table gather of sketch_kernels.pertable_counts (uint8 counters);
    byte and bit tables are read here in plain PyTorch (int32; only tests
    take them: the CLIs run kernels E-H on byte tables)."""
    if kind not in ("byte", "nibble", "bit"):
        raise NotImplementedError("%s tables are not yet ported" % kind)
    primes = tuple(int(p) for p in primes)

    def fn(tables, codes, lengths):
        W = codes.shape[-1] - k + 1
        hashes = H.hash_windows(codes, k, hash_family)
        win = torch.arange(W, device=codes.device)[None, :]
        valid = win <= (lengths.to(torch.int64)[:, None] - k)
        if kind == "nibble":
            per = K.pertable_counts(kind, primes, tables,
                                    hashes.reshape(-1).contiguous())
            return hashes, per.reshape(len(primes), *hashes.shape), valid
        per = []
        for t, p in enumerate(primes):
            bins = umod(hashes, p)
            if kind == "byte":
                c = tables[t][bins].to(torch.int32)
            else:
                byte = tables[t][bins // 8].to(torch.int32)
                bit = torch.bitwise_left_shift(
                    torch.ones_like(byte), (bins % 8).to(torch.int32))
                c = ((byte & bit) != 0).to(torch.int32)
            per.append(c)
        return hashes, torch.stack(per), valid

    return fn


def window_rows(seqs, k):
    """(codes uint8 [B, L], lengths int32 [B]) of a window's sequences, one
    a row, as JAX's SeqWindow packs them: B the row bucket of their number,
    L the length bucket of the longest, and at least k + 1; but rows hold
    the longest sequence whole (the JAX package caps them at MAX_ROW_LEN
    and cannot take a longer read; ROADMAP section 3). Encoded in one numpy
    pass over the joined sequences (diginorm_scan.pack_reads)."""
    longest = max(len(s) for s in seqs)
    L = max(pipeline._bucket_len(longest), longest, k + 1)
    B = pipeline._bucket_rows(len(seqs))
    codes = np.zeros((B, L), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    codes[:len(seqs)], lengths[:len(seqs)] = pack_reads(seqs, L)
    return codes, lengths


class SeqWindow:
    """Sequential-exact count evaluation over a window of sequences.

    One device pass gathers per-table base counts for every sequence;
    effective counts (reflecting consumes committed earlier within the
    window, tracked as adds per (table, counter)) then equal what the
    sequential reference would observe at each stream point. The
    window's distinct (table, counter) pairs are numbered on the device
    once (torch.unique), so the adds are one numpy array indexed by those
    numbers: a read's counts and consume are each one vectorized step on
    the host. On nibble tables kernel R's rows mode gives the valid
    windows' hashes, counters and flat nibble indices (which name the
    pairs) from the codes in one launch.
    """

    def __init__(self, graph, seqs):
        self.graph = graph
        self.k = graph.ksize()
        self._primes = tuple(graph._primes)
        self._sat = {"nibble": 15, "bit": 1}.get(
            graph.storage_kind, MAX_KCOUNT)
        self._delta = None
        self._consumed = False
        self._commit = []
        self._data = []
        if seqs:
            hashes, per, ids, repeats, lengths = self._eval(seqs)
            self._delta = np.zeros(int(ids.max()) + 1, dtype=np.int32)
            for s in range(len(seqs)):
                nwin = int(lengths[s]) - self.k + 1
                if nwin <= 0:
                    self._data.append((None, None, None, 0, False))
                    continue
                self._data.append((hashes[s, :nwin], per[:, s, :nwin],
                                   ids[:, s, :nwin], nwin,
                                   bool(repeats[s])))

    def _eval(self, seqs):
        """(hashes u64 [B, W], base counters [T, B, W] (uint8 on nibble
        tables), the number of each (table, counter) pair among the
        window's, int32 [T, B, W], whether a sequence's valid windows
        touch one pair more than once, bool [B], lengths [B]) of the
        window's sequences."""
        k = self.k
        codes, lengths = window_rows(seqs, k)
        dev = self.graph.device
        codes = torch.from_numpy(codes).to(dev)
        lengths_t = torch.from_numpy(lengths).to(dev)
        if self.graph.storage_kind == "nibble":
            if self.graph.hash_family != "twobit":
                raise NotImplementedError(
                    "nibble windows hash the twobit family, not %s"
                    % self.graph.hash_family)
            hashes, per, keys = K.nibble_pertable_rows(
                self._primes, self.graph.tables.flat, codes, lengths_t, k)
            valid = keys[0] >= 0
        else:
            fn = make_pertable_counts(self.graph.storage_kind, self._primes,
                                      k, self.graph.hash_family)
            hashes, per, valid = fn(self.graph.tables, codes, lengths_t)
            T = len(self._primes)
            keys = torch.stack([umod(hashes, p) * T + t
                                for t, p in enumerate(self._primes)])
        ids = torch.unique(keys, return_inverse=True)[1]
        # the rows whose valid windows touch one pair twice
        npairs = int(ids.max()) + 1
        B = codes.shape[0]
        row = torch.arange(B, device=dev)[None, :, None]
        seen, n = torch.unique((row * npairs + ids)[valid.expand_as(ids)],
                               return_counts=True)
        repeats = torch.zeros(B, dtype=torch.bool, device=dev)
        repeats[seen[n > 1] // npairs] = True
        return (hashes.cpu().numpy().view(np.uint64), per.cpu().numpy(),
                ids.to(torch.int32).cpu().numpy(), repeats.cpu().numpy(),
                lengths)

    def counts(self, idx):
        """Effective min-over-tables counts of sequence idx, as the
        sequential reference would see them right now."""
        h, base, ids, nwin, _ = self._data[idx]
        if nwin == 0:
            return np.zeros(0, np.int32)
        if not self._consumed:
            return base.min(axis=0).astype(np.int32)
        return np.minimum(base + self._delta[ids], self._sat).min(axis=0)

    def median(self, idx):
        """Medioid effective count of sequence idx (reference
        get_median_count); raises for one shorter than k, as JAX's does."""
        eff = self.counts(idx)
        if eff.size == 0:
            raise ValueError("no k-mer counts for this string; too short?")
        return int(np.sort(eff)[eff.size // 2])

    def consume(self, idx):
        """Record sequence idx as consumed (affects later counts)."""
        h, base, ids, nwin, repeats = self._data[idx]
        if nwin == 0:
            return
        self._commit.append(h)
        if repeats:  # a pair that it touches twice takes both adds
            np.add.at(self._delta, ids.ravel(), 1)
        else:
            self._delta[ids] += 1
        self._consumed = True

    def flush(self):
        """Apply all consumes to the sketch, in stream order."""
        if self._commit:
            self.graph._commit_hashes(np.concatenate(self._commit))
            self._commit = []


class BatchedNormalizer:
    """Window-batched exact diginorm engine."""

    def __init__(self, countgraph, desired_coverage):
        self.graph = countgraph
        self.C = int(desired_coverage)
        self.k = countgraph.ksize()

    def finalize(self):
        """No-op: this engine commits straight to the countgraph
        (interface parity with ScanNormalizer)."""

    def process_window(self, bundles):
        """bundles: list of lists of records (1 or 2 reads each).

        Returns, per bundle, the list of kept records — exactly as the
        sequential reference would decide.
        """
        n = len(bundles)
        kept_out = [[] for _ in range(n)]
        seqs = []
        for bundle in bundles:
            for r in bundle:
                seqs.append(r.cleaned_seq)
        if not seqs:
            return kept_out
        win = SeqWindow(self.graph, seqs)

        C = self.C
        si = 0
        for i, bundle in enumerate(bundles):
            idxs = list(range(si, si + len(bundle)))
            si += len(bundle)
            # keep iff any read's median < C (coverages_at_least -> all)
            all_at_least = True
            for idx in idxs:
                eff = win.counts(idx)
                if eff.size == 0:
                    continue
                min_req = int(0.5 + eff.size / 2.0)
                if int((eff >= C).sum()) < min_req:
                    all_at_least = False
                    break
            if not all_at_least:
                kept_out[i] = list(bundle)
                for idx in idxs:
                    win.consume(idx)
        win.flush()
        return kept_out
