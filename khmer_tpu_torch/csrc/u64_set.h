// Open-addressing tables of u64 for the port's host C++ (tag_spacing.cc,
// level_walk.h and the walks): a set, and a map of u64 to a u32 count or
// order; linear probing, at most 70% full, a splitmix64 finalizer to
// spread the hashes.
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

// A map of u64 to a u32 above 0 (the walks' keepers, the excursions'
// counts), in open addressing (linear probing, at most 70% full; value 0:
// an empty slot).
class U64Map {
 public:
  U64Map() { reset(64); }

  // v's value, 0 if it is absent
  uint32_t get(uint64_t v) const {
    for (size_t i = slot(v);; i = (i + 1) & mask_) {
      if (value_[i] == 0) return 0;
      if (keys_[i] == v) return value_[i];
    }
  }

  // add n (> 0) to v's value, 0 if it is absent; returns the new value
  uint32_t add(uint64_t v, uint32_t n) {
    if ((n_ + 1) * 10 >= keys_.size() * 7) grow();
    size_t i = slot(v);
    for (; value_[i] != 0; i = (i + 1) & mask_) {
      if (keys_[i] == v) return value_[i] += n;
    }
    keys_[i] = v;
    ++n_;
    return value_[i] = n;
  }

  size_t size() const { return n_; }

  // the bytes its slots take
  size_t bytes() const { return keys_.size() * (8 + 4); }

  // calls fn(v, value) for each member, in no order
  template <typename Fn>
  void each(Fn fn) const {
    for (size_t i = 0; i < keys_.size(); ++i) {
      if (value_[i] != 0) fn(keys_[i], value_[i]);
    }
  }

 private:
  size_t slot(uint64_t v) const {
    return static_cast<size_t>(mix64(v)) & mask_;
  }

  void reset(size_t cap) {
    keys_.assign(cap, 0);
    value_.assign(cap, 0);
    mask_ = cap - 1;
    n_ = 0;
  }

  void grow() {
    std::vector<uint64_t> keys = std::move(keys_);
    std::vector<uint32_t> value = std::move(value_);
    reset(keys.size() * 2);
    for (size_t i = 0; i < keys.size(); ++i) {
      if (value[i] != 0) add(keys[i], value[i]);
    }
  }

  std::vector<uint64_t> keys_;
  std::vector<uint32_t> value_;
  size_t mask_ = 0;
  size_t n_ = 0;
};

// The keeper of a walk: canonical k-mer -> the order it was kept in (1, 2,
// ...).
class Keeper : public U64Map {
 public:
  // its order, 0 if not kept
  uint32_t order(uint64_t v) const { return get(v); }

  // keep v (not kept yet); returns its order
  uint32_t keep(uint64_t v) {
    return add(v, static_cast<uint32_t>(size()) + 1);
  }
};

}  // namespace khmer_host
