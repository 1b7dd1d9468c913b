"""Host->device streaming pipeline — counterpart of
khmer_tpu/core/pipeline.py for the dense counting path (with its masked
and banded variants), the abundance histogram and the per-read counts
(counts_for_records: kernel H's counts mode on byte tables, kernel Q on
nibble ones).

Counting: the host packs reads (FlatPacker or the native parser) and
hashes them into fixed-size chunks of canonical k-mer hashes
(DenseHasher, native hg_hash_dense*, the 2-bit or the murmur family), and
each chunk is committed on the device by the sketch's update, in stream
order; a masked or banded consume first compacts each chunk to the
k-mers that pass its tests (kernel S, sketch_kernels.consume_filter).
The update is exact in stream order, so chunk sizes and tail padding
cannot change any result: every chunk, the tail included, has the one
size DENSE_CHUNK, zero-padded and masked by its count of valid hashes.
(JAX's tail-size ladder only bounded XLA recompiles; PyTorch runs
eagerly.)

The unique-k-mer count stays on the device and is read once, at the
end of the stream. With bigcount on, a byte-layout sketch also reads one
count per chunk, that of its update's saturation report
(_ByteStorage._absorb_saturation), and the report itself when it is not
empty; a masked or banded consume reads kernel S's count once a chunk
(the update takes it as an int).
"""

import numpy as np
import torch

from khmer_tpu_torch.core import hostengine
from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.sketch import _hashes_tensor
from khmer_tpu_torch.io import native
from khmer_tpu_torch.ops import hashing as H

# abundance-histogram batch geometry
TARGET_KMERS = 1 << 19
MAX_ROW_LEN = 4096
_L_LADDER = [64, 128, 256, 512, 1024, 2048, 4096]

# flat-stream pack chunk (host side of the dense path)
FLAT_CHUNK = 1 << 21
FLAT_MAX_READS = FLAT_CHUNK // 8

# dense-stream chunk: pre-hashed k-mers per device step
DENSE_CHUNK = 1 << 20


class FlatPacker:
    """Pack cleaned reads back-to-back into fixed-size 1-D code chunks
    plus the read start offsets.

    A read that does not fit in the remaining space is split: the next
    chunk starts with the last k-1 bases (no start marker: a
    continuation), so every k-window is produced exactly once, in stream
    order.
    """

    def __init__(self, k, chunk=FLAT_CHUNK):
        self.k = k
        self.chunk = chunk
        self._codes = np.zeros(chunk, dtype=np.uint8)
        self._starts = []
        self._fill = 0

    def add(self, seq):
        """Add one cleaned sequence. Returns a list of full chunks."""
        return self.add_codes(H.encode_dna(seq))

    def add_codes(self, codes):
        """Add one read's 2-bit codes (native-parser fast path)."""
        k = self.k
        out = []
        n = len(codes)
        if n < k:
            return out
        pos = 0  # next window start still to be produced
        while n - pos >= k:
            space = self.chunk - self._fill
            if space < k:
                out.append(self.flush())
                continue
            take = min(n - pos, space)
            if pos == 0:
                # new read: start marker (continuations re-enter at
                # offset 0 of a fresh chunk with no marker)
                self._starts.append(self._fill)
            self._codes[self._fill:self._fill + take] = \
                codes[pos:pos + take]
            self._fill += take
            if pos + take == n:
                break
            # chunk full mid-read: flush and continue with k-1 overlap
            out.append(self.flush())
            pos = pos + take - (k - 1)
        if self.chunk - self._fill < k:
            out.append(self.flush())
        return out

    def flush(self):
        """(codes[CHUNK], starts[FLAT_MAX_READS], nfill), or None when
        empty."""
        if self._fill == 0:
            return None
        if len(self._starts) > FLAT_MAX_READS:
            raise RuntimeError("too many reads in one chunk")
        starts = np.full(FLAT_MAX_READS, self.chunk, dtype=np.int32)
        starts[: len(self._starts)] = self._starts
        codes = self._codes
        nfill = self._fill
        self._codes = np.zeros(self.chunk, dtype=np.uint8)
        self._starts = []
        self._fill = 0
        return codes, starts, nfill


class DenseHasher:
    """Host side of the dense consume path: reads in, fixed-shape chunks
    of canonical k-mer hashes out, with no invalid entries before the
    tail's padding. Stream order is preserved end to end.
    """

    def __init__(self, k, hash_family, chunk=DENSE_CHUNK,
                 pack_chunk=FLAT_CHUNK):
        if hash_family not in hostengine.FAMILIES:
            raise NotImplementedError("the dense host hash has no %s family"
                                      % hash_family)
        self.k = k
        self.family = hash_family
        self.chunk = chunk
        self._packer = FlatPacker(k, chunk=pack_chunk)
        self._buf = np.empty(chunk, np.uint64)
        self._fill = 0

    def _hash(self, flat):
        codes, starts, nfill = flat
        return hostengine.hash_dense(codes, starts, nfill, self.k,
                                     self.family)

    def _push(self, dense):
        out = []
        n = len(dense)
        pos = 0
        while n - pos > 0:
            take = min(self.chunk - self._fill, n - pos)
            self._buf[self._fill:self._fill + take] = \
                dense[pos:pos + take]
            self._fill += take
            pos += take
            if self._fill == self.chunk:
                out.append((self._buf, self.chunk))
                self._buf = np.empty(self.chunk, np.uint64)
                self._fill = 0
        return out

    def add_codes(self, codes):
        """Add one read's 2-bit codes; returns full (hashes, n) chunks."""
        out = []
        for flat in self._packer.add_codes(codes):
            out.extend(self._push(self._hash(flat)))
        return out

    def add(self, seq):
        return self.add_codes(H.encode_dna(seq))

    def add_block(self, codes, offs, lens):
        """Add a whole native-parser block (one C call, no per-read
        Python); returns full (hashes, n) chunks. Don't interleave with
        per-read add() mid-stream — the packer buffer would reorder."""
        return self._push(hostengine.hash_dense_reads(codes, offs, lens,
                                                      self.k, self.family))

    def flush(self):
        """Flush the tail as one zero-padded full-size (hashes, n)
        chunk."""
        flat = self._packer.flush()
        out = []
        if flat is not None:
            out.extend(self._push(self._hash(flat)))
        if self._fill:
            tail = np.zeros(self.chunk, np.uint64)
            tail[: self._fill] = self._buf[: self._fill]
            out.append((tail, self._fill))
            self._fill = 0
        return out


def records_from(source):
    """Normalize a path / parser / record-iterable into a record iterator."""
    from khmer_tpu_torch.io.fastx import FastxParser

    if isinstance(source, str):
        return FastxParser(source)
    return source


def consume_seqfile(sketch, source, mask=None, threshold=0,
                    consume_masked=False, num_bands=None, band=None):
    """Count every k-mer of every read; returns (n_reads, n_consumed).

    Mirrors Hashtable::consume_seqfile and its _with_mask and _banding
    variants (src/oxli/hashtable.cc:125-274; JAX pipeline.py:553-692). A
    path goes through the native parser; a parser or record iterable goes
    read by read. With a band (num_bands, band: compute_band_interval) or
    a mask sketch, each chunk of host hashes goes through kernel S
    (sketch_kernels.consume_filter) before the update: a k-mer is counted
    only if its hash lies in the band and its count in the mask (the
    mask's gather, the least counter without the bigcount map) is <=
    threshold, or >= threshold with consume_masked. n_consumed counts the
    k-mers that pass.
    """
    k = sketch.ksize()
    band_interval = (H.compute_band_interval(num_bands, band)
                     if num_bands else None)
    if mask is not None and mask.device != sketch.device:
        raise ValueError("the mask must be on %s" % sketch.device)
    filtered = mask is not None or band_interval is not None
    hasher = DenseHasher(k, sketch.hash_family)
    n_reads = 0
    n_consumed = 0

    def commit(items):
        nonlocal n_consumed
        for harr, nvalid in items:
            h = _hashes_tensor(harr, sketch.device)
            if filtered:
                h = h[:nvalid]
                counts = None if mask is None else K._gather_counts(
                    mask.storage_kind, mask._primes, mask.tables, h)
                h, kept = K.consume_filter(h, nvalid, band_interval, counts,
                                           threshold, consume_masked)
                # the update takes its event count as an int: one read of
                # the device a chunk
                nvalid = int(kept[0])
            if nvalid:
                sketch._update(h, nvalid)
            n_consumed += nvalid

    if isinstance(source, str):
        for codes_blk, meta, _ in native.pack_blocks(source):
            n_reads += len(meta)
            commit(hasher.add_block(codes_blk, meta[:, 0], meta[:, 1]))
    else:
        for record in records_from(source):
            seq = record.cleaned_seq
            n_reads += 1
            if len(seq) >= k:
                commit(hasher.add(seq))
    commit(hasher.flush())
    return n_reads, n_consumed


def _bucket_len(n):
    for b in _L_LADDER:
        if n <= b:
            return b
    return MAX_ROW_LEN


def _bucket_rows(n):
    b = 64
    while b < n:
        b *= 2
    return b


class Batcher:
    """Pack cleaned sequences into shape-bucketed [B, L] code batches.

    Long sequences are split into MAX_ROW_LEN chunks overlapping by k-1 so
    every k-window is preserved, in order.
    """

    def __init__(self, k, target_kmers=TARGET_KMERS):
        self.k = k
        self.target = target_kmers
        self._rows = []   # list of np.uint8 code arrays
        self._kmers = 0
        self._maxlen = 0

    def add(self, seq):
        """Add one cleaned sequence; returns a packed batch (or a list of
        them, for a long sequence) when full, else None."""
        k = self.k
        n = len(seq)
        if n > MAX_ROW_LEN:
            out = []
            step = MAX_ROW_LEN - (k - 1)
            for s in range(0, n, step):
                chunk = seq[s:s + MAX_ROW_LEN]
                if len(chunk) < k and s > 0:
                    break
                b = self.add(chunk)
                if b is not None:
                    out.append(b)
            return out if out else None
        codes = H.encode_dna(seq)
        self._rows.append(codes)
        self._maxlen = max(self._maxlen, n)
        self._kmers += max(0, n - k + 1)
        if self._kmers >= self.target:
            return self.flush()
        return None

    def flush(self):
        """Pack and clear accumulated rows; None if empty."""
        if not self._rows:
            return None
        L = _bucket_len(max(self._maxlen, self.k))
        B = _bucket_rows(len(self._rows))
        codes = np.zeros((B, L), dtype=np.uint8)
        lengths = np.zeros(B, dtype=np.int32)
        for i, row in enumerate(self._rows):
            codes[i, : len(row)] = row
            lengths[i] = len(row)
        self._rows = []
        self._kmers = 0
        self._maxlen = 0
        return codes, lengths


# records counts_for_records reads in one window (kernel H's launches and
# host reads)
COUNTS_WINDOW = 16384


def counts_for_records(sketch, records, window=COUNTS_WINDOW):
    """Each record's k-mer counts, in order: (record, numpy uint32 counts
    of its cleaned sequence's windows; empty for one shorter than k), as
    JAX's pipeline.counts_for_records gives them (:755-817). A window of
    records goes up as 2-bit codes, a byte a base, packed in runs of one
    row length (diginorm_scan.row_runs). On a Countgraph's byte tables
    kernel H's counts mode returns each window's least counter, a byte a
    k-mer, and the host reads a 255 through the bigcount map
    (Countgraph._bigcount_fix); on a SmallCountgraph's nibble tables kernel
    Q's rows mode hashes the windows from the codes and returns each valid
    window's least counter, a byte a k-mer (JAX's device path:
    make_hash_batch, then _get_fn)."""
    if sketch.hash_family != "twobit":
        raise ValueError("counts_for_records reads the 2-bit graphs' tables, "
                         "not those of the %s hash" % sketch.hash_family)
    if sketch.storage_kind not in ("byte", "nibble"):
        raise ValueError("counts_for_records reads a Countgraph's byte "
                         "tables or a SmallCountgraph's nibble tables, not "
                         "%s ones" % sketch.storage_kind)
    batch = []
    for record in records_from(records):
        batch.append(record)
        if len(batch) >= window:
            yield from _window_counts(sketch, batch)
            batch = []
    yield from _window_counts(sketch, batch)


def _window_counts(sketch, records):
    from khmer_tpu_torch.core import sketch_kernels as K
    from khmer_tpu_torch.core.diginorm_scan import pack_reads, row_runs

    k = sketch.ksize()
    seqs = [r.cleaned_seq for r in records]
    live = [i for i, s in enumerate(seqs) if len(s) >= k]
    counts = [np.zeros(0, dtype=np.uint32)] * len(records)
    for start, stop, L in row_runs([[records[i]] for i in live], k):
        rows = live[start:stop]
        codes, lengths = pack_reads([seqs[i] for i in rows], L)
        codes = torch.from_numpy(codes).to(sketch.device)
        lengths = torch.from_numpy(lengths).to(sketch.device)
        if sketch.storage_kind == "byte":
            got = K.read_window_counts(sketch._primes, k, sketch.tables.flat,
                                       codes, lengths)
        else:
            got = K.nibble_row_counts(sketch._primes, sketch.tables.flat,
                                      codes, lengths, k)
        got = got.cpu().numpy().astype(np.uint32)
        for j, i in enumerate(rows):
            counts[i] = got[j, :len(seqs[i]) - k + 1]
    big = sketch._use_bigcount and sketch._bigcounts
    for i, record in enumerate(records):
        if big and len(counts[i]):
            sketch._bigcount_fix(counts[i], lambda: H.host_hash_windows(
                H.encode_dna(seqs[i]), k))
        yield record, counts[i]


def hash_batch(codes, lengths, k, hash_family="twobit"):
    """[B, L] codes + [B] lengths -> [B, W] canonical hashes of the 2-bit
    or the murmur family and the valid-window mask (khmer_tpu
    make_hash_batch)."""
    W = codes.shape[-1] - k + 1
    canon = H.hash_windows(codes, k, hash_family)
    win = torch.arange(W, device=codes.device)[None, :]
    valid = win <= (lengths[:, None].to(torch.int64) - k)
    return canon, valid


def abundance_distribution(main, source, tracking):
    """Histogram of k-mer counts over reads, deduplicated by `tracking`.

    Mirrors Hashtable::abundance_distribution (hashtable.cc:451-502):
    per k-mer in stream order, if tracking says unseen, track it and
    histogram the main count. Returns a list of MAX_BIGCOUNT+1 ints.
    """
    k = main.ksize()
    if tracking.ksize() != k:
        raise ValueError("tracking table k-size must match")
    if tracking.device != main.device:
        raise ValueError("tracking table must be on %s" % main.device)
    dev = main.device
    batcher = Batcher(k)
    # saturated counts resolve through the host-side bigcount map; only
    # a non-empty map needs their hashes on the host
    resolve = main._use_bigcount and bool(main._bigcounts)
    step = K.make_abund_dist(tracking.storage_kind, tracking._primes,
                             main.storage_kind, main._primes,
                             collect_sat=resolve)
    dist = torch.zeros(K.ABUND_BINS, dtype=torch.int64, device=dev)
    n_sat = torch.zeros((), dtype=torch.int64, device=dev)
    sat_hashes = []

    def commit(batch):
        nonlocal n_sat
        if batch is None:
            return
        if isinstance(batch, list):
            for b in batch:
                commit(b)
            return
        codes, lengths = batch
        hashes, valid = hash_batch(torch.from_numpy(codes).to(dev),
                                   torch.from_numpy(lengths).to(dev), k,
                                   main.hash_family)
        batch_sat, sat_hash = step(tracking.tables, dist, main.tables,
                                   hashes.reshape(-1), valid.reshape(-1))
        n_sat = n_sat + batch_sat
        if resolve:
            sat_hashes.append(sat_hash.cpu().numpy().view(np.uint64))

    for record in records_from(source):
        seq = record.cleaned_seq
        if len(seq) >= k:
            commit(batcher.add(seq))
    commit(batcher.flush())

    out = dist.cpu().numpy()
    if resolve:
        for h in np.concatenate(sat_hashes or [np.zeros(0, np.uint64)]):
            c = main._bigcounts.get(int(h), K.MAX_KCOUNT)
            out[min(c, K.MAX_BIGCOUNT)] += 1
    else:
        out[K.MAX_KCOUNT] += int(n_sat)
    return [int(x) for x in out]
