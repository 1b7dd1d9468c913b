"""User-facing sketch classes — counterpart of khmer_tpu/core/sketch.py.

A sketch holds its tables on a PyTorch device: a tuple of uint8
tensors, and its unique-k-mer count as an int64 [1] tensor beside them,
so a stream of updates never waits for the host. Updates run in place.
Every constructor and loader takes ``device``, "cuda" unless the caller
asks for another; with no CUDA device that raises, and never falls back
to the CPU. Ported here, each a hash family over a storage layout:

    Counttable        murmur hash + byte (Count-Min) storage
    SmallCounttable   murmur hash + nibble storage
    Nodetable         murmur hash + bit (Bloom) storage
    CyclicCounttable  cyclic hash + byte storage (hashed on the host)
    Countgraph        reversible 2-bit hash + byte storage (+graph ops)
    SmallCountgraph   reversible 2-bit hash + nibble storage (+graph ops)
    Nodegraph         reversible 2-bit hash + bit storage (+graph ops)

The byte layout keeps the host-side bigcount map (reference
storage.hh:513). The blocked tables are in core/blocked.py. The three
graphs are de Bruijn graphs (core/graphmixin.py): tagged as they consume,
probed for neighbours (kernels L, N and N's nibble mode), partitioned and
swept.
"""

import numpy as np
import torch

from khmer_tpu_torch.core import sketch_kernels as K
from khmer_tpu_torch.core.graphmixin import HashgraphMixin
from khmer_tpu_torch.ops import hashing as H
from khmer_tpu_torch.utils import trimming

MAX_KCOUNT = K.MAX_KCOUNT
MAX_BIGCOUNT = K.MAX_BIGCOUNT


def _resolve_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s was asked for, but PyTorch sees no "
                           "CUDA device" % device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _hashes_tensor(hashes, device):
    """numpy u64 hashes -> int64 tensor of the same bits on `device`."""
    h = np.ascontiguousarray(hashes, dtype=np.uint64).ravel()
    return torch.from_numpy(h.view(np.int64).copy()).to(device)


class _Sketch:
    """Base: k-mer hashing + batched sketch updates/queries."""

    storage_kind = None   # "byte" | "nibble" | "blocked" | "bit"
    hash_family = "twobit"  # "twobit" | "murmur" | "cyclic"
    supports_bigcount = False

    def __init__(self, ksize, primes, *, device="cuda"):
        if ksize > H.KSIZE_MAX:
            raise ValueError("k-mer size must be <= %d" % H.KSIZE_MAX)
        if ksize < 1:
            raise ValueError("k-mer size must be >= 1")
        self._ksize = int(ksize)
        self._primes = tuple(int(p) for p in primes)
        self.device = _resolve_device(device)
        self.tables = K.init_tables(self.storage_kind, self._primes,
                                    self.device)
        self._n_unique = torch.zeros(1, dtype=torch.int64,
                                     device=self.device)
        # n_occupied() keeps a loaded header's value (see n_occupied)
        self._occupied_offset = 0
        self._use_bigcount = False
        self._bigcounts = {}
        self._scratch = None

    def _update_scratch(self, nvalid, ntables):
        """The update kernel's scratch for a chunk of nvalid events, kept
        between chunks (sized by the chunk, never by the tables); None on
        the CPU, where the plain versions need none."""
        if self.device.type != "cuda":
            return None
        self._scratch = K.update_scratch(self._scratch, nvalid, ntables,
                                         self.device)
        return self._scratch

    # -- introspection ---------------------------------------------------

    def ksize(self):
        return self._ksize

    def hashsizes(self):
        return list(self._primes)

    def n_unique_kmers(self):
        return int(self._n_unique)

    def n_tables(self):
        return len(self._primes)

    def n_occupied(self):
        """Occupied bins in table 0.

        The reference tracks 0->1 transitions of table 0 only
        (storage.hh:581-589) and preserves the loaded header value on
        save even when stale; `_occupied_offset` (set on load) keeps
        that behavior while transitions are recomputed from the table.
        """
        return self._count_nonzero_t0() + self._occupied_offset

    # -- hashing ---------------------------------------------------------

    def hash(self, kmer):
        """Hash a k-mer string to its canonical 64-bit value."""
        if len(kmer) != self._ksize:
            raise ValueError("Expected k-mer length %d but got %d."
                             % (self._ksize, len(kmer)))
        if self.hash_family == "twobit":
            return H._hash_scalar(kmer, self._ksize)[0]
        if self.hash_family == "murmur":
            return H._hash_murmur_scalar(kmer)[0]
        raise NotImplementedError(self.hash_family)

    def reverse_hash(self, hashval):
        raise ValueError("reverse_hash not supported by this hash family")

    def _hashes_for_sequence(self, seq):
        """All canonical window hashes of one sequence (numpy uint64), on
        the host: the 2-bit family in numpy, murmur by the dense host
        hasher (csrc/dense_hash.cc), as JAX hashes a 2-bit sequence on the
        host (sketch.py:177-181)."""
        if len(seq) < self._ksize:
            return np.zeros(0, dtype=np.uint64)
        codes = H.encode_dna(seq)
        if self.hash_family == "twobit":
            return H.host_hash_windows(codes, self._ksize)
        from khmer_tpu_torch.core import hostengine

        return hostengine.hash_dense_reads(
            codes, np.zeros(1, np.int64), np.array([len(codes)], np.int64),
            self._ksize, self.hash_family)

    def _coerce_hashes(self, item):
        """str kmer | int hash | array -> uint64 numpy array."""
        if isinstance(item, str):
            return np.asarray([self.hash(item)], dtype=np.uint64)
        if isinstance(item, (int, np.integer)):
            return np.asarray([item], dtype=np.uint64)
        return np.asarray(item, dtype=np.uint64)

    # -- counting --------------------------------------------------------

    def _update(self, hashes, nvalid):
        """Commit hashes[:nvalid] (int64 tensor on the sketch's device) in
        stream order, in place, counting new k-mers into _n_unique."""
        raise NotImplementedError

    def _commit_hashes(self, hashes):
        """Apply a batch of canonical hashes (numpy u64) in order."""
        h = _hashes_tensor(hashes, self.device)
        if h.shape[0]:
            self._update(h, h.shape[0])
        return h.shape[0]

    def count(self, kmer):
        """Increment the count for one k-mer (str or hash)."""
        self._commit_hashes(self._coerce_hashes(kmer))
        return 1

    add = count

    # -- sequence-level ops ------------------------------------------------

    def consume(self, seq):
        """Count all k-mers in a sequence; returns how many."""
        if len(seq) < self._ksize:
            raise ValueError("sequence length must >= the hashtable k-size")
        return self._commit_hashes(self._hashes_for_sequence(seq))

    def get_kmers(self, seq):
        return [seq[i:i + self._ksize]
                for i in range(len(seq) - self._ksize + 1)]

    def get_kmer_hashes(self, seq):
        return [int(h) for h in self._hashes_for_sequence(seq)]

    def get_kmer_hashes_as_hashset(self, seq):
        return set(self.get_kmer_hashes(seq))

    def get(self, kmer):
        """Retrieve the count for one k-mer (str or hash)."""
        return int(self.get_counts_for_hashes(self._coerce_hashes(kmer))[0])

    def get_counts_for_hashes(self, hashes):
        """Counts (with the bigcount fixup) for an array of hashes -> numpy
        uint32."""
        hashes = np.asarray(hashes, dtype=np.uint64).ravel()
        if hashes.size == 0:
            return np.zeros(0, dtype=np.uint32)
        h = _hashes_tensor(hashes, self.device)
        counts = K._gather_counts(self.storage_kind, self._primes,
                                  self.tables, h)
        counts = counts.cpu().numpy().astype(np.uint32)
        if self._use_bigcount and self._bigcounts:
            for i in np.nonzero(counts == MAX_KCOUNT)[0]:
                counts[i] = self._bigcounts.get(int(hashes[i]), MAX_KCOUNT)
        return counts

    # -- sequence count ops (JAX sketch.py:351-435), over the gather -------

    def get_kmer_counts(self, seq):
        """Each k-mer's count, a list of ints; [] for a sequence shorter
        than k."""
        return [int(c) for c in self.get_counts_for_hashes(
            self._hashes_for_sequence(seq))]

    def get_min_count(self, seq):
        counts = self.get_kmer_counts(seq)
        return min(min(counts), MAX_KCOUNT) if counts else MAX_KCOUNT

    def get_max_count(self, seq):
        counts = self.get_kmer_counts(seq)
        return max(counts) if counts else 0

    def get_median_count(self, seq):
        """(median, average, stddev) of the k-mer counts of a sequence
        (median_avg_stddev)."""
        counts = self.get_counts_for_hashes(self._hashes_for_sequence(seq))
        if counts.size == 0:
            raise ValueError("no k-mer counts for this string; too short?")
        return median_avg_stddev(counts)

    def median_at_least(self, seq, cutoff):
        """True if the medioid count is >= cutoff (diginorm primitive;
        reference hashtable.cc:333-364)."""
        counts = self.get_counts_for_hashes(self._hashes_for_sequence(seq))
        if counts.size == 0:
            raise ValueError("no k-mer counts for this string; too short?")
        return trimming.median_at_least_from_counts(counts, self._ksize,
                                                    cutoff, len(seq))

    def trim_on_abundance(self, seq, min_abund):
        """Trim at the first k-mer below min_abund: (trimmed_seq, trim_at)
        (reference hashtable.cc:504-533)."""
        pos = self._trim_pos(seq, min_abund, below=False)
        return seq[:pos], pos

    def trim_below_abundance(self, seq, max_abund):
        """Trim at the first k-mer above max_abund: (trimmed_seq,
        trim_at)."""
        pos = self._trim_pos(seq, max_abund, below=True)
        return seq[:pos], pos

    def _trim_pos(self, seq, cutoff, below):
        counts = self.get_counts_for_hashes(self._hashes_for_sequence(seq))
        return trimming.trim_pos_from_counts(counts, self._ksize, cutoff,
                                             len(seq), below=below)

    def find_spectral_error_positions(self, seq, max_abund):
        """The positions of the runs of k-mers of count <= max_abund (the
        "errors"; reference hashtable.cc:565-612)."""
        counts = self.get_counts_for_hashes(self._hashes_for_sequence(seq))
        if counts.size == 0:
            raise ValueError("sequence too short")
        posns = []
        n = counts.size
        i = 0
        while i < n and counts[i] <= max_abund:  # the first trusted k-mer
            i += 1
        if i == n:
            return posns
        if i > 0:
            posns.append(i - 1)
        while i < n:
            if counts[i] <= max_abund:
                posns.append(i + self._ksize - 1)
                while i < n and counts[i] <= max_abund:
                    i += 1
            else:
                i += 1
        return posns

    # -- bigcount --------------------------------------------------------

    def set_use_bigcount(self, value):
        if value and not self.supports_bigcount:
            raise ValueError("Bigcount is not supported for this storage.")
        self._use_bigcount = bool(value)

    def get_use_bigcount(self):
        return self._use_bigcount

    # -- file-level ops ----------------------------------------------------

    def consume_seqfile(self, path_or_parser):
        """Count all k-mers in a FASTA/FASTQ file.

        Returns (n_reads, n_consumed). Reference: hashtable.cc:125-150.
        """
        from khmer_tpu_torch.core import pipeline

        return pipeline.consume_seqfile(self, path_or_parser)

    def consume_seqfile_with_mask(self, path_or_parser, mask, threshold=0,
                                  consume_masked=False):
        """consume_seqfile of only the k-mers whose count in `mask` is <=
        threshold (>= threshold with consume_masked); reference
        hashtable.cc:152-196. Returns (n_reads, n_consumed)."""
        from khmer_tpu_torch.core import pipeline

        return pipeline.consume_seqfile(
            self, path_or_parser, mask=mask, threshold=threshold,
            consume_masked=consume_masked)

    def consume_seqfile_banding(self, path_or_parser, num_bands, band):
        """consume_seqfile of only the k-mers whose hash lies in band
        `band` of `num_bands` (reference hashtable.cc:198-232)."""
        from khmer_tpu_torch.core import pipeline

        return pipeline.consume_seqfile(
            self, path_or_parser, num_bands=num_bands, band=band)

    def consume_seqfile_banding_with_mask(self, path_or_parser, num_bands,
                                          band, mask, threshold=0,
                                          consume_masked=False):
        from khmer_tpu_torch.core import pipeline

        return pipeline.consume_seqfile(
            self, path_or_parser, num_bands=num_bands, band=band, mask=mask,
            threshold=threshold, consume_masked=consume_masked)

    def abundance_distribution(self, path_or_parser, tracking):
        from khmer_tpu_torch.core import pipeline

        return pipeline.abundance_distribution(self, path_or_parser,
                                               tracking)

    def abundance_distribution_with_reads_parser(self, parser, tracking):
        return self.abundance_distribution(parser, tracking)

    # -- save/load (OXLI) --------------------------------------------------

    def get_raw_tables(self):
        """Numpy copies of the raw table bytes."""
        return [t.cpu().numpy() for t in self.tables]

    def save(self, filename):
        from khmer_tpu_torch.core import oxli_io

        oxli_io.save_sketch(self, filename)

    @classmethod
    def load(cls, filename, *, device="cuda"):
        from khmer_tpu_torch.core import oxli_io

        return oxli_io.load_sketch(cls, filename, device=device)

    @classmethod
    def from_numpy_state(cls, ksize, primes, tables, n_unique,
                         occupied_offset, device="cuda", bigcounts=None,
                         use_bigcount=False):
        """A sketch of this class holding the given state: its primes, the
        tables as numpy uint8 arrays (e.g. ``np.asarray(t)`` for each of a
        JAX sketch's tables), the unique count, the occupancy offset and,
        for a Countgraph, the bigcount map and flag."""
        obj = cls(ksize, 1, 1, primes=primes, device=device)
        if len(tables) != len(obj.tables):
            raise ValueError("expected %d tables" % len(obj.tables))
        for dst, src in zip(obj.tables, tables):
            src = np.ascontiguousarray(src, dtype=np.uint8)
            if src.shape != tuple(dst.shape):
                raise ValueError("table shape %s, expected %s"
                                 % (src.shape, tuple(dst.shape)))
            dst.copy_(torch.from_numpy(src.copy()))
        obj._n_unique.fill_(int(n_unique))
        obj._occupied_offset = int(occupied_offset)
        obj.set_use_bigcount(use_bigcount)
        obj._bigcounts = {int(h): int(c)
                          for h, c in (bigcounts or {}).items()}
        return obj


class _Sized(_Sketch):
    """A sketch of T prime-sized tables, sized as the reference's are
    (k, starting_size, n_tables) or by its primes."""

    def __init__(self, ksize, starting_size, n_tables, primes=None, *,
                 device="cuda"):
        if primes is None:
            primes = K.get_n_primes_near_x(int(n_tables), int(starting_size))
        super().__init__(ksize, primes, device=device)


class _ByteStorage(_Sized):
    """The exact byte layout: T prime-sized u8 tables of 8-bit saturating
    counters, views into one flat buffer (sketch_kernels.ByteTables),
    counts past 255 in the host-side bigcount map when bigcount is on
    (set_use_bigcount). On a CUDA device the update is kernel A, which
    keeps only the chunk's scratch (sketch_kernels.update_plan), nothing
    the size of the tables."""

    storage_kind = "byte"
    supports_bigcount = True

    def _update(self, hashes, nvalid, with_event_new=False):
        """Kernel A (or its plain version) on hashes[:nvalid], the bigcount
        report folded into the map; with with_event_new, returns each
        event's new flag (bool [nvalid] on the device)."""
        out = K.byte_update(
            self._primes, self.tables.flat, self._n_unique, hashes, nvalid,
            with_bigcount=self._use_bigcount,
            scratch=self._update_scratch(nvalid, len(self._primes)),
            with_event_new=with_event_new)
        report, flags = out if with_event_new else (out, None)
        if report is not None:
            self._absorb_saturation(*report)
        return flags

    def _update_with_flags(self, hashes, nvalid):
        """_update, returning each event's new flag (the tagged consume)."""
        return self._update(hashes, nvalid, with_event_new=True)

    def _absorb_saturation(self, cand_hash, cand_old, n_cand):
        """Fold an update's bigcount report into the map. Reading its
        count is the one device-to-host read of an update."""
        n = int(n_cand[0])
        if n == 0:
            return
        hs = cand_hash[:n].cpu().numpy().view(np.uint64)
        ms = cand_old[:n].cpu().numpy()
        for h, triggers in K.bigcount_triggers(hs, ms).items():
            self._bigcount_add(h, triggers)

    def _bigcount_add(self, h, triggers):
        b = self._bigcounts.get(h, 0)
        self._bigcounts[h] = min(max(b, MAX_KCOUNT) + triggers,
                                 MAX_BIGCOUNT)

    def _count_nonzero_t0(self):
        return int(K.byte_occupied(self.tables[0]))


class _NibbleStorage(_Sized):
    """The nibble layout: T prime-sized tables of 4-bit saturating
    counters, two a byte, views into one flat buffer (sketch_kernels.
    NibbleTables): half the memory of the byte tables for the same size.
    No bigcount. On a CUDA device the update is kernel P, which keeps only
    the chunk's scratch, and the counts come from kernel Q."""

    storage_kind = "nibble"

    def _update_scratch(self, nvalid, ntables):
        """Kernel P's scratch for a chunk of nvalid events
        (sketch_kernels.nibble_update_plan, sized by the chunk), kept
        between chunks; None on the CPU."""
        if self.device.type != "cuda":
            return None
        self._scratch = K.nibble_update_scratch(self._scratch, nvalid,
                                                ntables, self.device)
        return self._scratch

    def _update(self, hashes, nvalid, with_event_new=False):
        """Kernel P (or its plain version) on hashes[:nvalid]; with
        with_event_new, returns each event's new flag (bool [nvalid] on
        the device)."""
        return K.nibble_update(
            self._primes, self.tables.flat, self._n_unique, hashes, nvalid,
            scratch=self._update_scratch(nvalid, len(self._primes)),
            with_event_new=with_event_new)

    def _update_with_flags(self, hashes, nvalid):
        """_update, returning each event's new flag (the tagged consume)."""
        return self._update(hashes, nvalid, with_event_new=True)

    def _count_nonzero_t0(self):
        return int(K.nibble_occupied(self.tables[0]))


class _BitStorage(_Sized):
    """The bit (Bloom filter) layout: T prime-sized bit tables, views into
    one flat buffer (sketch_kernels.BitTables). On a CUDA device the
    update is kernel J, which keeps only the chunk's scratch."""

    storage_kind = "bit"

    def _update(self, hashes, nvalid):
        """Kernel J (or its plain version) on hashes[:nvalid]; returns each
        event's new flag, which J gives at no cost."""
        return K.bit_update(self._primes, self.tables, self._n_unique,
                            hashes, nvalid,
                            scratch=self._update_scratch(
                                nvalid, len(self._primes)))

    _update_with_flags = _update

    def _count_nonzero_t0(self):
        return int(K.bit_occupied(self.tables[0]))


class _MurmurMixin:
    """The murmur hash family (reference Counttable and its kin): not
    reversible."""

    hash_family = "murmur"


class Counttable(_MurmurMixin, _ByteStorage):
    """Count-Min sketch of 8-bit counters with the murmur hash (reference
    Counttable; JAX sketch.py:524)."""


class SmallCounttable(_MurmurMixin, _NibbleStorage):
    """Count-Min sketch of 4-bit counters with the murmur hash (JAX
    sketch.py:531)."""


class Nodetable(_MurmurMixin, _BitStorage):
    """Bloom filter with the murmur hash (JAX sketch.py:537); count and add
    return 1, as every sketch's do."""


class CyclicCounttable(_ByteStorage):
    """Count-Min sketch of 8-bit counters with the cyclic rolling hash
    (JAX sketch.py:549): the reference wraps a third-party CyclicHash
    (irreversible, h + r canonical); the windows are hashed on the host
    (ops/cyclic.py) and committed on the card."""

    hash_family = "cyclic"

    # events a commit of the file consume gathers first (JAX's 2^18)
    COMMIT_EVENTS = 1 << 18

    def hash(self, kmer):
        from khmer_tpu_torch.ops import cyclic

        if len(kmer) != self._ksize:
            raise ValueError("Expected k-mer length %d but got %d."
                             % (self._ksize, len(kmer)))
        return cyclic.hash_cyclic(kmer, self._ksize)

    def _hashes_for_sequence(self, seq):
        from khmer_tpu_torch.ops import cyclic

        if len(seq) < self._ksize:
            return np.zeros(0, dtype=np.uint64)
        return cyclic.hash_cyclic_windows(seq, self._ksize)

    def consume_seqfile(self, path_or_parser):
        """Count every k-mer of every read, the cyclic window hashes from
        the host's closed form committed a batch of COMMIT_EVENTS or more
        at a time; returns (n_reads, n_consumed)."""
        from khmer_tpu_torch.core import pipeline

        k = self._ksize
        n_reads = n_consumed = buffered = 0
        buf = []
        for record in pipeline.records_from(path_or_parser):
            seq = record.cleaned_seq
            n_reads += 1
            if len(seq) >= k:
                hashes = self._hashes_for_sequence(seq)
                buf.append(hashes)
                buffered += hashes.size
                n_consumed += int(hashes.size)
                if buffered >= self.COMMIT_EVENTS:
                    self._commit_hashes(np.concatenate(buf))
                    buf, buffered = [], 0
        if buf:
            self._commit_hashes(np.concatenate(buf))
        return n_reads, n_consumed


class Countgraph(HashgraphMixin, _ByteStorage):
    """Count-Min sketch of 8-bit saturating counters over T prime tables,
    with the 2-bit hash, and a de Bruijn graph (reference Countgraph; JAX
    khmer_tpu Countgraph, sketch.py:704-714). Its sequence counts come
    from kernel H, which hashes a read's 2-bit codes itself."""

    def __init__(self, ksize, starting_size, n_tables, primes=None, *,
                 device="cuda"):
        super().__init__(ksize, starting_size, n_tables, primes,
                         device=device)
        self._init_graph()

    # -- sequence-level queries (kernel H) ----------------------------------

    def _bigcount_fix(self, counts, hashes_of):
        """Read each count of 255 (numpy uint32, in place) through the
        bigcount map where the sketch uses one; hashes_of() gives the
        counts' hashes."""
        if self._use_bigcount and self._bigcounts:
            sat = np.nonzero(counts == MAX_KCOUNT)[0]
            if sat.size:
                hashes = hashes_of()
                for i in sat:
                    counts[i] = self._bigcounts.get(int(hashes[i]),
                                                    MAX_KCOUNT)
        return counts

    def get_kmer_counts(self, seq):
        """Each k-mer's count (kernel H's counts mode, with the bigcount
        map), a list of ints; [] for a sequence shorter than k."""
        if len(seq) < self._ksize:
            return []
        codes = H.encode_dna(seq)
        row = torch.from_numpy(codes[None, :].copy()).to(self.device)
        length = torch.tensor([codes.shape[0]], dtype=torch.int32,
                              device=self.device)
        counts = K.read_window_counts(self._primes, self._ksize,
                                      self.tables.flat, row, length)
        counts = counts[0].cpu().numpy().astype(np.uint32)
        self._bigcount_fix(counts, lambda: H.host_hash_windows(
            codes, self._ksize))
        return [int(c) for c in counts]

    def get_median_count(self, seq):
        """(median, average, stddev) of the k-mer counts of a sequence: the
        medioid, and the float32 average and deviation summed in order
        (median_avg_stddev; reference hashtable.cc:299-328)."""
        counts = np.asarray(self.get_kmer_counts(seq), dtype=np.uint32)
        if counts.size == 0:
            raise ValueError("no k-mer counts for this string; too short?")
        return median_avg_stddev(counts)

    def _read_counts(self, seq, cutoff, at_least):
        """Kernel H (sketch_kernels.read_counts) on one sequence of at
        least k bases, with the bigcount map: (its trim position under
        `cutoff`, its windows at or above `at_least`)."""
        codes = H.encode_dna(seq)
        row = torch.from_numpy(codes[None, :].copy()).to(self.device)
        length = torch.tensor([codes.shape[0]], dtype=torch.int32,
                              device=self.device)
        big = None
        if self._use_bigcount and self._bigcounts:
            big = K.bigcount_table(self._bigcounts, self.device)
        trim_at, n_ge = K.read_counts(self._primes, self._ksize, cutoff,
                                      at_least, self.tables.flat, row,
                                      length, big)
        return int(trim_at[0]), int(n_ge[0])

    def median_at_least(self, seq, cutoff):
        """True if the medioid count is >= cutoff (diginorm primitive;
        reference hashtable.cc:333-364)."""
        if len(seq) < self._ksize:
            raise ValueError("no k-mer counts for this string; too short?")
        _, n_ge = self._read_counts(seq, 0, cutoff)
        min_req = int(0.5 + (len(seq) - self._ksize + 1) / 2.0)
        return n_ge >= min_req

    def trim_on_abundance(self, seq, min_abund):
        """Trim at the first k-mer below min_abund.

        Returns (trimmed_seq, trim_at) — reference: hashtable.cc:504-533;
        a sequence with one k-mer, or none, trims to 0.
        """
        if len(seq) < self._ksize:
            return seq[:0], 0
        pos, _ = self._read_counts(seq, min_abund, 0)
        return seq[:pos], pos


def median_avg_stddev_rows(counts):
    """(median int64 [R], average float32 [R], stddev float32 [R]) of each
    row of a count matrix [R, n], n >= 1, as the reference computes them
    for a sequence (hashtable.cc:299-328; JAX sketch.py
    _median_avg_stddev): the sorted middle element (rounding down), and
    the average and the standard deviation summed in float32 one count
    after another (np.cumsum in float32 adds in order along the row;
    np.sum would add pairwise)."""
    counts = np.asarray(counts)
    n = np.float32(counts.shape[1])
    c = counts.astype(np.float32)
    average = np.cumsum(c, axis=1, dtype=np.float32)[:, -1] / n
    d = c - average[:, None]
    var = np.cumsum(d * d, axis=1, dtype=np.float32)[:, -1] / n
    median = np.sort(counts, axis=1)[:, counts.shape[1] // 2]
    return median.astype(np.int64), average, np.sqrt(var)


def median_avg_stddev(counts):
    """(median, average, stddev) of one sequence's counts (numpy [n], n >=
    1): median_avg_stddev_rows of one row, as Python numbers."""
    med, avg, std = median_avg_stddev_rows(np.asarray(counts)[None, :])
    return int(med[0]), float(avg[0]), float(std[0])


class SmallCountgraph(HashgraphMixin, _NibbleStorage):
    """Count-Min sketch of 4-bit saturating counters over T prime tables,
    with the 2-bit hash (reference SmallCountgraph; JAX sketch.py:716-723),
    and a de Bruijn graph: tagged as it consumes (kernel P's new flags),
    its neighbours probed by kernel N's nibble mode
    (sketch_kernels.nibble_neighbors)."""

    def __init__(self, ksize, starting_size, n_tables, primes=None, *,
                 device="cuda"):
        super().__init__(ksize, starting_size, n_tables, primes,
                         device=device)
        self._init_graph()


class Nodegraph(HashgraphMixin, _BitStorage):
    """Bloom filter with the 2-bit hash (reference Nodegraph), and a de
    Bruijn graph (core/graphmixin.py)."""

    def __init__(self, ksize, starting_size, n_tables, primes=None, *,
                 device="cuda"):
        super().__init__(ksize, starting_size, n_tables, primes,
                         device=device)
        self._init_graph()

    def update(self, other):
        """The bitwise OR of an equal-shaped Nodegraph into this one (the
        Bloom union; reference Nodegraph::update_from, hashgraph.cc:
        892-907): n_unique becomes the larger of the two, a lower bound,
        as JAX's sketch.py:735-751 computes it."""
        if self._ksize != other._ksize or self._primes != other._primes:
            raise ValueError(
                "both nodegraphs must have same ksize and table sizes")
        self.tables.flat |= other.tables.flat.to(self.device)
        torch.maximum(self._n_unique, other._n_unique.to(self.device),
                      out=self._n_unique)

    update_from = update


def from_numpy_state(ksize, primes, tables, n_unique, occupied_offset,
                     device="cuda", kind="bit", **graph_state):
    """A graph of storage kind `kind` ("bit": a Nodegraph, "byte": a
    Countgraph, "nibble": a SmallCountgraph) holding the given state (see
    _Sketch.from_numpy_state)."""
    cls = {"bit": Nodegraph, "byte": Countgraph,
           "nibble": SmallCountgraph}[kind]
    return cls.from_numpy_state(ksize, primes, tables, n_unique,
                                occupied_offset, device, **graph_state)
