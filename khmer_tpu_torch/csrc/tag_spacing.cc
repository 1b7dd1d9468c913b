// The tag-spacing pass of Hashgraph::consume_seqfile_and_tag (reference
// src/oxli/hashgraph.cc:200-271; khmer_tpu/core/graphmixin.py:206-235
// _tag_spacing_step and _tag_spacing_tail), on the host, with its tag set.
//
// The pass is sequential over the whole stream: whether a k-mer that is
// not new resets the spacing depends on the tags placed before it, in this
// read or an earlier one. The device gives each k-mer's new flag (kernel
// J); this pass walks the k-mers in stream order and places the tags. It
// is built with g++ at first use (khmer_tpu_torch/ops/host.py) and keeps
// the tags in an open-addressing set of u64 (u64_set.h).

#include <cstdint>
#include <cstring>
#include <vector>

#include "u64_set.h"

namespace {

using khmer_host::U64Set;

// The spacing state carried across chunks: the k-mers since the last tag,
// the last k-mer of the current read, and whether a read is open.
enum { kSince = 0, kLast = 1, kOpen = 2 };

// End of a read: tag its last k-mer if the spacing warrants it.
void end_read(U64Set* tags, int density, int64_t* state) {
  if (state[kOpen] && state[kSince] >= density / 2 - 1) {
    tags->insert(static_cast<uint64_t>(state[kLast]));
  }
  state[kOpen] = 0;
}

}  // namespace

extern "C" {

void* kt_set_new(long long hint) {
  return new U64Set(hint > 0 ? static_cast<size_t>(hint) : 0);
}

void kt_set_free(void* set) { delete static_cast<U64Set*>(set); }

void kt_set_add(void* set, const uint64_t* values, long long n) {
  U64Set* s = static_cast<U64Set*>(set);
  for (long long i = 0; i < n; ++i) s->insert(values[i]);
}

long long kt_set_size(void* set) {
  return static_cast<long long>(static_cast<U64Set*>(set)->size());
}

void kt_set_export(void* set, uint64_t* out) {
  static_cast<U64Set*>(set)->export_to(out);
}

// For each of n groups of consecutive values (counts[i] values each), the
// index in `values` of its first member of the set, -1 if none: each read's
// first tagged k-mer in the annotation of partitions.
void kt_set_first_member(void* set, const uint64_t* values,
                         const int64_t* counts, long long n, int64_t* out) {
  const U64Set* s = static_cast<const U64Set*>(set);
  int64_t at = 0;
  for (long long i = 0; i < n; ++i) {
    out[i] = -1;
    for (int64_t j = at; j < at + counts[i]; ++j) {
      if (s->contains(values[j])) {
        out[i] = j;
        break;
      }
    }
    at += counts[i];
  }
}

// The spacing pass over n k-mers in stream order: hashes, their new flags
// and read_start (1 on the first k-mer of each read). state [3] carries
// (since, last k-mer, open) from the chunk before; a fresh stream starts
// with open 0. Returns the new k-mers.
long long kt_tag_spacing(void* set, const uint64_t* hashes,
                         const uint8_t* is_new, const uint8_t* read_start,
                         long long n, int density, int64_t* state) {
  U64Set* tags = static_cast<U64Set*>(set);
  long long n_new = 0;
  int64_t since = state[kSince];
  for (long long i = 0; i < n; ++i) {
    const uint64_t kmer = hashes[i];
    if (read_start[i]) {
      state[kSince] = since;
      end_read(tags, density, state);
      since = density / 2 + 1;
    }
    if (is_new[i]) {
      ++n_new;
      ++since;
    } else if (tags->contains(kmer)) {
      since = 1;
    } else {
      ++since;
    }
    if (since >= density) {
      tags->insert(kmer);
      since = 1;
    }
    state[kLast] = static_cast<int64_t>(kmer);
    state[kOpen] = 1;
  }
  state[kSince] = since;
  return n_new;
}

// The end of the stream: close the open read.
void kt_tag_spacing_end(void* set, int density, int64_t* state) {
  end_read(static_cast<U64Set*>(set), density, state);
}

}  // extern "C"
