"""The tagging and partitioning part of the de Bruijn graph API —
counterpart of khmer_tpu/core/graphmixin.py (HashgraphMixin :62-350,
373-418, 437-554).

A Nodegraph or a Countgraph tags every _tag_density-th k-mer while it
consumes reads (Hashgraph::consume_sequence_and_tag, reference
src/oxli/hashgraph.cc:200-271). The host hashes the reads (the dense
hasher of config 1, csrc/dense_hash.cc) and keeps the hashes; the card
commits each chunk through kernel J (sketch_kernels.bit_update) on a
Nodegraph or kernel A (sketch_kernels.byte_update, with the bigcount map)
on a Countgraph, whose per-event new flags come back at one byte a k-mer;
the spacing pass, sequential over the whole stream, runs on the host in
C++ (csrc/tag_spacing.cc, ops/host.py). A node's neighbours are probed on
the card by kernel L (sketch_kernels.neighbors) in bit tables, kernel N
(sketch_kernels.byte_neighbors) in byte tables and its nibble mode
(sketch_kernels.nibble_neighbors) in nibble tables, which partitioning and
the perimeter sweep (core/partition.py) drive a breadth level at a time,
as do the knot pipeline's excursions (core/traversal.py), whose
repartition turns the highly connected k-mers into stop tags. The other
traversals and labels are not ported yet.
"""

import numpy as np

from khmer_tpu_torch.ops import hashing as H

DEFAULT_TAG_DENSITY = 40   # reference: include/oxli/oxli.hh:83

# bases of reads a record-path block of the tagged consume packs
RECORD_BLOCK_BASES = 1 << 22


def _record_blocks(records, block_bases=RECORD_BLOCK_BASES):
    """(codes, offsets, lengths) blocks of cleaned records, in order."""
    codes, lens, have = [], [], 0
    for record in records:
        c = H.encode_dna(record.cleaned_seq)
        codes.append(c)
        lens.append(len(c))
        have += len(c)
        if have >= block_bases:
            yield _pack(codes, lens)
            codes, lens, have = [], [], 0
    if lens:
        yield _pack(codes, lens)


def _pack(codes, lens):
    lens = np.asarray(lens, dtype=np.int64)
    offs = np.cumsum(lens) - lens
    return np.concatenate(codes), offs, lens


def read_blocks(source):
    """(codes, offsets, lengths) blocks of a file (the native parser) or
    of a parser or record iterable, in stream order."""
    from khmer_tpu_torch.core.pipeline import records_from
    from khmer_tpu_torch.io import native

    if isinstance(source, str):
        for codes, meta, _ in native.pack_blocks(source):
            yield codes, meta[:, 0], meta[:, 1]
        return
    yield from _record_blocks(records_from(source))


def dense_hashes(codes, offs, lens, k):
    """Canonical 2-bit hashes of every k-mer of a block's reads, in order
    (reads shorter than k give none), and the flag of each read's first
    k-mer."""
    from khmer_tpu_torch.core import hostengine

    hashes = hostengine.hash_dense_reads(codes, offs, lens, k, "twobit")
    nwin = np.maximum(np.asarray(lens, dtype=np.int64) - k + 1, 0)
    read_start = np.zeros(len(hashes), np.uint8)
    read_start[(np.cumsum(nwin) - nwin)[nwin > 0]] = 1
    return hashes, read_start


def check_probe_kind(graph):
    """Raise unless the graph's tables have a neighbour probe: kernel L
    (bit tables), N (byte tables) or N's nibble mode (nibble tables). The
    blocked layout has none yet."""
    if graph.storage_kind not in ("bit", "byte", "nibble"):
        raise NotImplementedError(
            "the neighbour probe of %s tables (a %s's graph) is not yet "
            "ported" % (graph.storage_kind, type(graph).__name__))


class HashgraphMixin:
    """The graph API mixed into Countgraph, SmallCountgraph and
    Nodegraph."""

    @classmethod
    def from_numpy_state(cls, ksize, primes, tables, n_unique,
                         occupied_offset, device="cuda", bigcounts=None,
                         use_bigcount=False, all_tags=(), stop_tags=(),
                         tag_density=None):
        """A graph holding the given state (see _Sketch.from_numpy_state),
        with its tags, stop tags and, where given, tag density (e.g. a JAX
        graph's)."""
        obj = super().from_numpy_state(ksize, primes, tables, n_unique,
                                       occupied_offset, device, bigcounts,
                                       use_bigcount)
        obj.all_tags = set(int(t) for t in all_tags)
        obj.stop_tags = set(int(t) for t in stop_tags)
        if tag_density is not None:
            obj._set_tag_density(int(tag_density))
        return obj

    def _init_graph(self):
        self.all_tags = set()
        self.stop_tags = set()
        self._tag_density = DEFAULT_TAG_DENSITY
        self._partition = None
        # tags whose excursion was small: repartition skips them after
        self.repart_small_tags = set()

    @property
    def partition(self):
        """The graph's own SubsetPartition (reference Hashgraph keeps
        one for merge/annotate operations)."""
        if self._partition is None:
            from khmer_tpu_torch.core.partition import SubsetPartition

            self._partition = SubsetPartition(self)
        return self._partition

    def merge_subset(self, subset):
        self.partition.merge(subset)

    def merge_subset_from_disk(self, filename):
        self.partition.merge_from_disk(filename)

    def output_partitions(self, infile, outfile, output_unassigned=False):
        return self.partition.output_partitioned_file(
            infile, outfile, output_unassigned)

    def load_partitionmap(self, filename):
        self.partition.load_partitionmap(filename)

    def save_partitionmap(self, filename):
        self.partition.save_partitionmap(filename)

    def count_partitions(self):
        return self.partition.count_partitions()

    def assign_partition_id(self, kmer, tagged_kmers):
        return self.partition.assign_partition_id(kmer, tagged_kmers)

    # -- tag density / sets ----------------------------------------------

    def _get_tag_density(self):
        return self._tag_density

    def _set_tag_density(self, d):
        if d % 2 != 0:
            raise ValueError("tag density must be even")
        self._tag_density = d

    def n_tags(self):
        return len(self.all_tags)

    def add_tag(self, kmer):
        self.all_tags.add(self._tag_hash(kmer))

    def get_tagset(self):
        return [self.reverse_hash(t) for t in sorted(self.all_tags)]

    def _tag_hash(self, kmer):
        if isinstance(kmer, str):
            return self.hash(kmer)
        return int(kmer)

    def add_stop_tag(self, kmer):
        self.stop_tags.add(self._tag_hash(kmer))

    def n_stop_tags(self):
        return len(self.stop_tags)

    def get_stop_tags(self):
        return [self.reverse_hash(t) for t in sorted(self.stop_tags)]

    def load_stop_tags(self, path, clear_tags=True):
        from khmer_tpu_torch.core import oxli_io

        st = oxli_io.load_stoptags(path, self._ksize)
        if clear_tags:
            self.stop_tags = st
        else:
            self.stop_tags |= st

    def save_stop_tags(self, path):
        from khmer_tpu_torch.core import oxli_io

        oxli_io.save_stoptags(path, self._ksize, self.stop_tags)

    def print_tagset(self, path):
        with open(path, "w") as f:
            for t in sorted(self.all_tags):
                f.write(self.reverse_hash(t) + "\n")

    def print_stop_tags(self, path):
        with open(path, "w") as f:
            for t in sorted(self.stop_tags):
                f.write(self.reverse_hash(t) + "\n")

    def trim_on_stoptags(self, seq):
        """Trim at the first stop tag k-mer (hashgraph.cc:487-501): at
        k - 2 + i for a stop tag at window i. Returns (seq, position)."""
        hashes = self._hashes_for_sequence(seq)
        for i, h in enumerate(hashes.tolist()):
            if h in self.stop_tags:
                pos = self._ksize - 2 + i
                return seq[:pos], pos
        return seq, len(seq)

    def repartition_largest_partition(self, counts, distance, threshold,
                                      frequency, subs=None):
        """Make the highly connected k-mers of the largest partition of
        `subs` (the graph's own partition, if None) stop tags and
        partition its tags again (reference graphs.pyx:755,
        subset.cc:1218; core/partition.py). Returns the size of the
        next-largest partition."""
        target = subs if subs is not None else self.partition
        return target.repartition_largest_partition(
            distance, threshold, frequency, counts)

    def divide_tags_into_subsets(self, subset_size):
        """Every subset_size-th tag, in sorted order (reference
        Hashgraph::divide_tags_into_subsets, hashgraph.cc:349-362)."""
        return sorted(self.all_tags)[::subset_size]

    def reverse_hash(self, hashval):
        return H.reverse_hash(int(hashval), self._ksize)

    def get_tags_for_sequence(self, seq):
        """Tags present among the sequence's k-mers
        (hashgraph.cc:324-342)."""
        return [int(h) for h in self._hashes_for_sequence(seq)
                if int(h) in self.all_tags]

    # -- the spacing rule, in Python (the reference of csrc/tag_spacing.cc)

    def _tag_spacing_step(self, hashes, is_new, since, found_tags=None):
        """Incremental spacing pass over one segment of a read."""
        density = self._tag_density
        n_consumed = 0
        all_tags = self.all_tags
        kmer = None
        for i in range(hashes.shape[0]):
            kmer = int(hashes[i])
            if is_new[i]:
                n_consumed += 1
                since += 1
            elif kmer in all_tags:
                since = 1
                if found_tags is not None:
                    found_tags.add(kmer)
            else:
                since += 1
            if since >= density:
                all_tags.add(kmer)
                if found_tags is not None:
                    found_tags.add(kmer)
                since = 1
        return n_consumed, since, kmer

    def _tag_spacing_tail(self, since, kmer, found_tags=None):
        """End-of-read rule: tag the last k-mer if spacing warrants."""
        if since >= self._tag_density // 2 - 1 and kmer is not None:
            self.all_tags.add(kmer)
            if found_tags is not None:
                found_tags.add(kmer)

    # -- the tagged consume -------------------------------------------------

    def consume_seqfile_and_tag(self, source):
        """Count every k-mer of every read and tag the graph; returns
        (total_reads, n_consumed), n_consumed the k-mers that were new
        (reference Hashgraph::consume_seqfile_and_tag, hashgraph.cc:
        279-320). Each block's hashes are committed in chunks of at most
        pipeline.DENSE_CHUNK k-mers through the sketch's update, whose
        per-event new flags drive the spacing pass."""
        from khmer_tpu_torch.core import pipeline
        from khmer_tpu_torch.core.sketch import _hashes_tensor
        from khmer_tpu_torch.ops.host import TagSpacing

        chunk = pipeline.DENSE_CHUNK
        k = self._ksize
        spacing = TagSpacing(self.all_tags, self._tag_density)
        total_reads = 0
        n_consumed = 0
        try:
            for codes, offs, lens in read_blocks(source):
                total_reads += len(lens)
                hashes, read_start = dense_hashes(codes, offs, lens, k)
                for lo in range(0, len(hashes), chunk):
                    h = hashes[lo:lo + chunk]
                    flags = self._update_with_flags(
                        _hashes_tensor(h, self.device), len(h))
                    n_consumed += spacing.step(
                        h, flags.cpu().numpy(), read_start[lo:lo + chunk])
            self.all_tags = spacing.end()
        finally:
            spacing.close()
        return total_reads, n_consumed

    def consume_seqfile_and_tag_with_reads_parser(self, parser):
        return self.consume_seqfile_and_tag(parser)

    def consume_and_tag(self, seq):
        """Count and tag one sequence; returns its new k-mers (reference
        Hashgraph::consume_sequence_and_tag, hashgraph.cc:200-271)."""
        n, _ = self._consume_and_tag_seq(seq)
        return n

    def _consume_and_tag_seq(self, seq, found_tags=None):
        from khmer_tpu_torch.core.sketch import _hashes_tensor

        hashes = self._hashes_for_sequence(seq)
        if hashes.size == 0:
            return 0, found_tags
        flags = self._update_with_flags(_hashes_tensor(hashes, self.device),
                                        len(hashes))
        since = self._tag_density // 2 + 1
        n_consumed, since, kmer = self._tag_spacing_step(
            hashes, flags.cpu().numpy(), since, found_tags)
        self._tag_spacing_tail(since, kmer, found_tags)
        return n_consumed, found_tags

    def consume_partitioned_fasta(self, filename):
        """Tag each read's first k-mer in the partition its name gives and
        count every read (core/partition.py consume_partitioned_fasta); the
        graph's partition becomes the file's. Returns (total reads, new
        k-mers)."""
        from khmer_tpu_torch.core.partition import consume_partitioned_fasta

        total_reads, n_consumed, subset = consume_partitioned_fasta(
            self, filename)
        self._partition = subset
        return total_reads, n_consumed

    # -- tagset persistence ---------------------------------------------------

    def save_tagset(self, path):
        from khmer_tpu_torch.core import oxli_io

        oxli_io.save_tagset(path, self._ksize, self.all_tags,
                            self._tag_density)

    def load_tagset(self, path, clear_tags=True):
        from khmer_tpu_torch.core import oxli_io

        tags, density = oxli_io.load_tagset(path, self._ksize)
        if clear_tags:
            self.all_tags = tags
        else:
            self.all_tags |= tags
        self._tag_density = density

    def get_tags_and_positions(self, seq):
        """(k + i, tag) for each window i of the sequence that is a tag."""
        return [(i + self._ksize, int(h))
                for i, h in enumerate(self._hashes_for_sequence(seq))
                if int(h) in self.all_tags]

    def find_all_tags_list(self, kmer):
        """The tags the partition walk from one k-mer finds, as a list."""
        from khmer_tpu_torch.core import partition as P

        _, f, r = H._hash_scalar(kmer, self._ksize)
        return [int(t) for t in P.find_all_tags(self, f, r)]

    def sweep_tag_neighborhood(self, seq, range=0,
                               break_on_stop_tags=False,
                               stop_big_traversals=False):
        """The tags within `range` of the sequence's k-mers
        (SubsetPartition::sweep_for_tags, subset.cc:305-394), as a set."""
        from khmer_tpu_torch.core.partition import sweep_for_tags

        return sweep_for_tags(self, seq, range, break_on_stop_tags,
                              stop_big_traversals)[0]

    # -- neighbours (kernels L and N) -----------------------------------------

    def neighbors_batch(self, f_arr, r_arr):
        """(nf, nr, ncanon, present) numpy arrays [N, 8] for arrays of
        (f, r) k-mers, as JAX's make_neighbors_fn gives them: the
        neighbours rebuilt on the host from (f, r), their presence from
        kernel L's byte a node (N's on a Countgraph, N's nibble mode's on
        a SmallCountgraph)."""
        from khmer_tpu_torch.core import sketch_kernels as K
        from khmer_tpu_torch.core.sketch import _hashes_tensor

        check_probe_kind(self)
        f = _hashes_tensor(f_arr, self.device)
        r = _hashes_tensor(r_arr, self.device)
        probe = {"byte": K.byte_neighbors, "nibble": K.nibble_neighbors,
                 "bit": K.neighbors}[self.storage_kind]
        masks = probe(self._primes, self.tables.flat, f, r,
                      self._ksize).cpu().numpy()
        nf, nr = K.neighbor_kmers(f.cpu(), r.cpu(), self._ksize)
        nf = nf.numpy().view(np.uint64)
        nr = nr.numpy().view(np.uint64)
        present = ((masks[:, None] >> np.arange(8)) & 1).astype(bool)
        return nf, nr, np.minimum(nf, nr), present

    def neighbors(self, kmer):
        """Present neighbor canonical hashes of one k-mer (str or hash)."""
        f, r = self._fr_for(kmer)
        _, _, nc, present = self.neighbors_batch(
            np.array([f], np.uint64), np.array([r], np.uint64))
        return [int(nc[0, i]) for i in range(8) if present[0, i]]

    def _fr_for(self, kmer):
        if isinstance(kmer, str):
            if len(kmer) != self._ksize:
                raise ValueError(
                    "Expected k-mer length %d but got %d."
                    % (self._ksize, len(kmer)))
            _, f, r = H._hash_scalar(kmer, self._ksize)
            return f, r
        # hash given: reconstruct the sequence (reversible hash)
        s = H.reverse_hash(int(kmer), self._ksize)
        _, f, r = H._hash_scalar(s, self._ksize)
        return f, r

    def kmer_degree(self, kmer_f, kmer_r=None):
        """Number of present neighbors (hashgraph.cc:473-485)."""
        if isinstance(kmer_f, str) and kmer_r is None:
            f, r = self._fr_for(kmer_f)
        elif isinstance(kmer_f, str):
            _, f, _ = H._hash_scalar(kmer_f, self._ksize)
            _, r, _ = H._hash_scalar(kmer_r, self._ksize)
        else:
            f, r = int(kmer_f), int(kmer_r)
        _, _, _, present = self.neighbors_batch(
            np.array([f], np.uint64), np.array([r], np.uint64))
        return int(present[0].sum())

    def find_high_degree_nodes(self, seq):
        """The sequence's k-mers with more than two present neighbours
        (hashgraph.cc:820-841), as a set."""
        import torch

        if len(seq) < self._ksize:
            return set()
        canon, f, r = H.rolling_hash_windows(
            torch.from_numpy(H.encode_dna(seq)), self._ksize)
        _, _, _, present = self.neighbors_batch(
            f.numpy().view(np.uint64), r.numpy().view(np.uint64))
        deg = present.sum(axis=1)
        return set(int(h) for h, d in zip(canon.numpy().view(np.uint64), deg)
                   if d > 2)

    def extract_unique_paths(self, seq, min_length, min_unique_f):
        """The maximal windows of the sequence whose k-mers are mostly
        unseen (reference hashgraph.cc:723-817, its endpoint adjustments
        too)."""
        if len(seq) < min_length:
            return []
        max_seen = 1.0 - min_unique_f
        min_length = min_length - self._ksize + 1
        counts = self.get_counts_for_hashes(self._hashes_for_sequence(seq))
        seen = [bool(c) for c in counts]
        n_kmers = len(seen)
        results = []
        i = 0
        while i < n_kmers - min_length:
            seen_counter = sum(1 for j in range(min_length) if seen[i + j])
            if (seen_counter / float(min_length)) <= max_seen:
                start = i
                while (start + min_length) < n_kmers:
                    if seen[start]:
                        seen_counter -= 1
                    if seen[start + min_length]:
                        seen_counter += 1
                    start += 1
                    if (seen_counter / float(min_length)) > max_seen:
                        break
                if start + min_length == n_kmers:
                    if (seen_counter / float(min_length)) > max_seen:
                        start -= 1
                    start -= 1
                else:
                    start -= 2
                results.append(seq[i: start + min_length + self._ksize])
                i = start + min_length + 1
            else:
                i += 1
        return results

    # -- partitioning --------------------------------------------------------

    def do_subset_partition(self, start_kmer=0, end_kmer=0,
                            break_on_stoptags=False,
                            stop_big_traversals=False):
        from khmer_tpu_torch.core.partition import SubsetPartition

        subset = SubsetPartition(self)
        subset.do_partition(start_kmer, end_kmer, break_on_stoptags,
                            stop_big_traversals)
        return subset

    def do_subset_partition_with_abundance(self, min_count, max_count,
                                           start_kmer=0, end_kmer=0,
                                           break_on_stop_tags=False,
                                           stop_big_traversals=False):
        """Partition only through the k-mers whose count lies in
        [min_count, max_count] (reference graphs.pyx:833-855,
        subset.cc:557-613)."""
        from khmer_tpu_torch.core.partition import SubsetPartition

        subset = SubsetPartition(self)
        subset.do_partition_with_abundance(
            start_kmer, end_kmer, min_count, max_count, break_on_stop_tags,
            stop_big_traversals)
        return subset
