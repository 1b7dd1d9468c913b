// An open-addressing set of u64 for the port's host C++ (tag_spacing.cc,
// tag_walk.cc): linear probing, at most 70% full, a splitmix64 finalizer
// to spread the hashes.
#pragma once

#include <cstddef>
#include <cstdint>
#include <utility>
#include <vector>

namespace khmer_host {

// splitmix64's finalizer: spreads a hash over a table's slots
inline uint64_t mix64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDULL;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ULL;
  h ^= h >> 33;
  return h;
}

class U64Set {
 public:
  explicit U64Set(size_t hint) { resize(capacity_for(hint)); }

  bool contains(uint64_t v) const {
    for (size_t i = slot(v);; i = (i + 1) & mask_) {
      if (!used_[i]) return false;
      if (keys_[i] == v) return true;
    }
  }

  void insert(uint64_t v) {
    if ((n_ + 1) * 10 >= keys_.size() * 7) resize(keys_.size() * 2);
    for (size_t i = slot(v);; i = (i + 1) & mask_) {
      if (!used_[i]) {
        used_[i] = 1;
        keys_[i] = v;
        ++n_;
        return;
      }
      if (keys_[i] == v) return;
    }
  }

  size_t size() const { return n_; }

  // the members, in no order; out holds at least size() values
  void export_to(uint64_t* out) const {
    size_t j = 0;
    for (size_t i = 0; i < keys_.size(); ++i) {
      if (used_[i]) out[j++] = keys_[i];
    }
  }

 private:
  static size_t capacity_for(size_t n) {
    size_t cap = 64;
    while (cap * 7 <= n * 10 + 10) cap <<= 1;
    return cap;
  }

  size_t slot(uint64_t h) const {
    return static_cast<size_t>(mix64(h)) & mask_;
  }

  void resize(size_t cap) {
    std::vector<uint64_t> keys = std::move(keys_);
    std::vector<uint8_t> used = std::move(used_);
    keys_.assign(cap, 0);
    used_.assign(cap, 0);
    mask_ = cap - 1;
    n_ = 0;
    for (size_t i = 0; i < keys.size(); ++i) {
      if (used[i]) insert(keys[i]);
    }
  }

  std::vector<uint64_t> keys_;
  std::vector<uint8_t> used_;
  size_t mask_ = 0;
  size_t n_ = 0;
};

}  // namespace khmer_host
