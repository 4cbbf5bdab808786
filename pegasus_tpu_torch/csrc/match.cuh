// Byte matching, key-tile staging and mask packing shared by the port's
// Hopper kernels: csrc/scan_predicate.cu (the scan predicate) and
// csrc/compaction_filter.cu (the compaction filter). Each kernel file is
// its own translation unit and includes this header once; everything here
// has internal linkage.
//
// The matcher implements match_filter (ops/predicates.py) for a pattern
// of at least one byte; an empty pattern is the caller's decision (it
// matches everything on the scan path and nothing in compaction rules).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// filter types (idl/rrdb.thrift); FT_MATCH_ANYWHERE = 1 is the fall-through
constexpr int kPrefix = 2;
constexpr int kPostfix = 3;

constexpr int kTile = 256;            // records (threads) per thread block
constexpr int kMaxStagedWidth = 256;  // widest key row staged in smem

struct Filter {
  const uint8_t* pat;  // 4-byte aligned, zero-padded to a multiple of 4
  int32_t len;         // 0: matches everything (match_region)
  int32_t type;
};

// Bytes [o, o + 4) of a 4-byte aligned row; the caller keeps them
// inside the row.
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int o) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (o >> 2);
  const int sh = (o & 3) * 8;
  return sh == 0 ? w[0] : __funnelshift_r(w[0], w[1], sh);
}

// row[o, o + plen) == pat[0, plen), the range inside the row.
__device__ bool equal_at(const uint8_t* row, int o, const uint8_t* pat,
                         int plen) {
  const uint32_t* pw = reinterpret_cast<const uint32_t*>(pat);
  int j = 0;
  for (; j + 4 <= plen; j += 4) {
    if (load_word(row, o + j) != __ldg(pw + (j >> 2))) return false;
  }
  for (; j < plen; ++j) {
    if (row[o + j] != __ldg(pat + j)) return false;
  }
  return true;
}

// FT_MATCH_ANYWHERE: some start t in [max(start, 0), min(start + len -
// plen, k - 1)] where the pattern matches, bytes past k reading zero.
__device__ bool find_anywhere(const uint8_t* row, int k, int start, int len,
                              const uint8_t* pat, int plen) {
  const int t_lo = max(start, 0);
  const int t_hi = min(start + len - plen, k - 1);
  const uint8_t c0 = __ldg(pat);
  const uint32_t c4 = 0x01010101u * c0;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
  for (int a = t_lo & ~3; a <= t_hi; a += 4) {
    uint32_t hits = __vcmpeq4(words[a >> 2], c4);
    if (a < t_lo) hits &= 0xFFFFFFFFu << ((t_lo - a) * 8);
    if (a + 3 > t_hi) hits &= 0xFFFFFFFFu >> ((a + 3 - t_hi) * 8);
    while (hits) {
      const int byte = (__ffs(hits) - 1) >> 3;
      hits &= ~(0xFFu << (byte * 8));
      const int t = a + byte;
      if (t + plen <= k) {
        if (equal_at(row, t, pat, plen)) return true;
        continue;
      }
      bool ok = true;
      for (int j = 1; j < plen && ok; ++j) {
        const int pos = t + j;
        ok = (pos < k ? row[pos] : 0) == __ldg(pat + j);
      }
      if (ok) return true;
    }
  }
  return false;
}

// PREFIX and POSTFIX of match_region for a pattern of plen >= 1 bytes
// and a region at least as long: compare from offs (the region's start,
// or its end less plen), reading clip(offs + j, 0, K - 1) where the
// bytes leave the row.
__device__ bool match_fixed(const uint8_t* row, int k, int offs,
                            const uint8_t* pat, int plen) {
  if (offs >= 0 && offs + plen <= k) return equal_at(row, offs, pat, plen);
  for (int j = 0; j < plen; ++j) {
    const int idx = min(max(offs + j, 0), k - 1);
    if (row[idx] != __ldg(pat + j)) return false;
  }
  return true;
}

// Semantics of match_filter (ops/predicates.py): an empty pattern matches
// everything; the region must be at least as long as the pattern; PREFIX
// and POSTFIX read clip(offset + j, 0, K - 1); ANYWHERE tries starts t in
// [0, K) inside the region and reads zero bytes past K. Regions of
// malformed rows may be negative or run past the row.
__device__ bool match_region(const uint8_t* row, int k, int start, int len,
                             const Filter& f) {
  const int plen = f.len;
  if (plen == 0) return true;
  if (len < plen) return false;
  if (f.type == kPrefix || f.type == kPostfix) {
    return match_fixed(row, k, f.type == kPrefix ? start : start + len - plen,
                       f.pat, plen);
  }
  return find_anywhere(row, k, start, len, f.pat, plen);
}

// Copy a tile's n key rows (one contiguous range of n x k bytes from row
// `base`) into shared memory at a row stride of k + 4 (the threads of a
// warp reading one offset of their rows hit 32 different banks), with
// 16-byte loads, neighbouring threads on neighbouring addresses. Every
// thread of the block calls it; the caller waits for the block
// (__syncthreads) before reading the tile.
__device__ __forceinline__ void stage_keys(const uint8_t* keys, int64_t base,
                                           int n, int k, int k_shift,
                                           uint8_t* tile_keys) {
  const int stride = k + 4;
  const uint4* src = reinterpret_cast<const uint4*>(
      keys + (static_cast<size_t>(base) << k_shift));
  const int chunks = (n << k_shift) >> 4;
  for (int c = threadIdx.x; c < chunks; c += kTile) {
    const uint4 v = __ldcs(src + c);
    const int byte = c << 4;
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        tile_keys + (byte >> k_shift) * stride + (byte & (k - 1)));
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

// Write a warp's ballot of bits as packbits bytes of a mask at `out` (the
// mask's first byte): lane i's bit is bit i of `bits`, and packbits wants
// record 8j + m at bit 7 - m of byte j, so the bits are reversed, then
// byte-swapped; four lanes write four bytes. `first` is the warp's first
// record, `count` the mask's records.
__device__ __forceinline__ void write_packed(unsigned bits, int64_t first,
                                             int64_t count, uint8_t* out) {
  if (first < count) {
    const int lane = threadIdx.x & 31;
    const int64_t left = (count - first + 7) >> 3;
    const int nbytes = left < 4 ? static_cast<int>(left) : 4;
    const uint32_t packed = __byte_perm(__brev(bits), 0, 0x0123);
    if (lane < nbytes) {
      out[(first >> 3) + lane] = static_cast<uint8_t>(packed >> (8 * lane));
    }
  }
}

// The same bytes written by one lane: `bits` is the ballot of the warp
// whose first record is `first`, `out` the mask's first byte. One 4-byte
// store where the warp's four bytes are all in the mask and 4-byte
// aligned (a block's mask starts at any byte), else a byte store each.
__device__ __forceinline__ void write_packed_lane(unsigned bits,
                                                  int64_t first,
                                                  int64_t count,
                                                  uint8_t* out) {
  if (first >= count) return;
  const int64_t left = (count - first + 7) >> 3;
  const int nbytes = left < 4 ? static_cast<int>(left) : 4;
  const uint32_t packed = __byte_perm(__brev(bits), 0, 0x0123);
  uint8_t* p = out + (first >> 3);
  if (nbytes == 4 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p) = packed;
    return;
  }
  for (int i = 0; i < nbytes; ++i) {
    p[i] = static_cast<uint8_t>(packed >> (8 * i));
  }
}

}  // namespace
