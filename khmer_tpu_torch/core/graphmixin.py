"""The tagging and partitioning part of the de Bruijn graph API —
counterpart of khmer_tpu/core/graphmixin.py (HashgraphMixin :62-150,
198-350, 373-418, 520-528).

A Nodegraph tags every _tag_density-th k-mer while it consumes reads
(Hashgraph::consume_sequence_and_tag, reference src/oxli/hashgraph.cc:
200-271). The host hashes the reads (the dense hasher of config 1,
csrc/dense_hash.cc) and keeps the hashes; the card commits each chunk
through kernel J (sketch_kernels.bit_update), whose per-event new flags
come back at one byte a k-mer; the spacing pass, sequential over the
whole stream, runs on the host in C++
(csrc/tag_spacing.cc, ops/host.py). A node's neighbours are probed on
the card by kernel L (sketch_kernels.neighbors), which partitioning
(core/partition.py) drives a breadth level at a time, as do the knot
pipeline's excursions (core/traversal.py), whose repartition turns the
highly connected k-mers into stop tags. The other traversals and labels
are not ported yet.
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


class HashgraphMixin:
    """Tagging mixed into Nodegraph."""

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

    def _hashes_for_sequence(self, seq):
        """All canonical window hashes of one sequence (numpy uint64)."""
        if len(seq) < self._ksize:
            return np.zeros(0, dtype=np.uint64)
        return H.host_hash_windows(H.encode_dna(seq), self._ksize)

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
                    flags = self._update(_hashes_tensor(h, self.device),
                                         len(h))
                    n_consumed += spacing.step(
                        h, flags.cpu().numpy(), read_start[lo:lo + chunk])
            self.all_tags = spacing.end()
        finally:
            spacing.close()
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

    # -- neighbours (kernel L) -----------------------------------------------

    def neighbors_batch(self, f_arr, r_arr):
        """(nf, nr, ncanon, present) numpy arrays [N, 8] for arrays of
        (f, r) k-mers, as JAX's make_neighbors_fn gives them: the
        neighbours rebuilt on the host from (f, r), their presence from
        kernel L's byte a node."""
        from khmer_tpu_torch.core import sketch_kernels as K
        from khmer_tpu_torch.core.sketch import _hashes_tensor

        f = _hashes_tensor(f_arr, self.device)
        r = _hashes_tensor(r_arr, self.device)
        masks = K.neighbors(self._primes, self.tables.flat, f, r,
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

    # -- partitioning --------------------------------------------------------

    def do_subset_partition(self, start_kmer=0, end_kmer=0,
                            break_on_stoptags=False,
                            stop_big_traversals=False):
        from khmer_tpu_torch.core.partition import SubsetPartition

        subset = SubsetPartition(self)
        subset.do_partition(start_kmer, end_kmer, break_on_stoptags,
                            stop_big_traversals)
        return subset
