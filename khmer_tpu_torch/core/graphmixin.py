"""The tagging part of the de Bruijn graph API — counterpart of
khmer_tpu/core/graphmixin.py (HashgraphMixin :107-118, 198-350).

A Nodegraph tags every _tag_density-th k-mer while it consumes reads
(Hashgraph::consume_sequence_and_tag, reference src/oxli/hashgraph.cc:
200-271). The host hashes the reads (the dense hasher of config 1,
src/hostgraph.cc hg_hash_dense_reads) and keeps the hashes; the card
commits each chunk through kernel J (sketch_kernels.bit_update), whose
per-event new flags come back at one byte a k-mer; the spacing pass,
sequential over the whole stream, runs on the host in C++
(csrc/tag_spacing.cc, ops/host.py). Traversal, partitioning and labels
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
    """(codes, offsets, lengths) blocks of a file (the native parser, when
    it is available) or of a parser or record iterable, in stream order."""
    from khmer_tpu_torch.core.pipeline import records_from
    from khmer_tpu_torch.io import native

    if isinstance(source, str) and native.available():
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
    if hashes is None:
        parts = [H.host_hash_windows(codes[o:o + n], k)
                 for o, n in zip(offs, lens) if n >= k]
        hashes = (np.concatenate(parts) if parts
                  else np.zeros(0, np.uint64))
    nwin = np.maximum(np.asarray(lens, dtype=np.int64) - k + 1, 0)
    read_start = np.zeros(len(hashes), np.uint8)
    read_start[(np.cumsum(nwin) - nwin)[nwin > 0]] = 1
    return hashes, read_start


class HashgraphMixin:
    """Tagging mixed into Nodegraph."""

    def _init_graph(self):
        self.all_tags = set()
        self._tag_density = DEFAULT_TAG_DENSITY

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
