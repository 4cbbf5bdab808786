// The key hash of the JAX package's ops/device_crc.py:65
// `key_hash_device`, shared by the scan kernel (scan_predicate.cu, its
// key-hash instances) and the compaction kernel (compaction_filter.cu):
// the lo lane of pegasus_key_hash (src/base/pegasus_key_schema.h:150),
// the crc64 of the hashkey region of a padded key row, or of the sortkey
// region when the hashkey is empty. The plain version is
// ops/device_crc.key_hash_device.
//
// What bounds it on an H100: not the bytes (a key row is read once,
// about 12 hashed bytes a serving row) but the table lookups, one 64-bit
// shared-memory load a hashed byte. PR 8 hashed a byte at a time over one
// 256-entry table: a chain of dependent lookups, each index waiting for
// the last.
//
// The redesign (PR 9): 4 slicing tables of 256 uint64, table i holding
// the crc64 step of byte b from a zero state followed by i zero bytes
// (table 0 is base/crc.py's TABLE64; ops/fused_scan.crc_tables builds
// them on the host, one copy a device, and a block stages them, 8 KB, in
// shared memory). A step xors a 4-byte word into the state's low lane and
// looks its four bytes up in tables 3..0: four independent lookups, so
// the dependent chain is one step a word. The region starts at byte 2 of
// a 4-byte aligned row: bytes 2 and 3 go one at a time, then whole words,
// then a partial last word one byte at a time, then the malformed-row
// tail (bytes past K read row[K - 1], as the JAX function's clip does).
// Times: scan_predicate.cu's note and PERF.md.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// slicing tables: crc64 steps of one byte followed by 0..3 zero bytes
// (ops/fused_scan.CRC_SLICES)
constexpr int kCrcSlices = 4;
constexpr int kCrcWords = kCrcSlices * 256;

// Stage the kCrcSlices tables from `src` (device memory, 16-byte
// aligned) into the block's shared `dst` (16-byte aligned). Every thread
// of the block calls it; the caller waits for the block (__syncthreads)
// before the first lookup.
__device__ __forceinline__ void stage_crc_tables(
    unsigned long long* dst, const unsigned long long* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < kCrcWords / 2; i += blockDim.x) {
    d[i] = __ldg(s + i);
  }
}

__device__ __forceinline__ unsigned long long crc_byte(
    unsigned long long crc, uint32_t byte, const unsigned long long* tab) {
  return tab[(static_cast<uint32_t>(crc) ^ byte) & 0xFF] ^ (crc >> 8);
}

// 4 bytes (w, little-endian) in one step: four independent lookups in
// tables 3..0
__device__ __forceinline__ unsigned long long crc_word(
    unsigned long long crc, uint32_t w, const unsigned long long* tab) {
  const uint32_t a = static_cast<uint32_t>(crc) ^ w;
  return (crc >> 32) ^ tab[3 * 256 + (a & 0xFF)] ^
         tab[2 * 256 + ((a >> 8) & 0xFF)] ^ tab[256 + ((a >> 16) & 0xFF)] ^
         tab[a >> 24];
}

// The lo lane of key_hash_device over a 4-byte aligned key row of width
// k (shared or device memory), read a word at a time: crc64 over bytes
// [2, 2 + n), bytes at or past k reading row[k - 1] (the JAX function's
// clip(start + j, 0, K - 1) gather over K steps). `tab` holds the
// slicing tables.
__device__ __forceinline__ uint32_t key_hash_lo(
    const uint8_t* row, int k, int klen, int hkl,
    const unsigned long long* tab) {
  const int n = min(max(hkl > 0 ? hkl : klen - 2, 0), k);
  const int end = 2 + min(n, k - 2);  // bytes [2, end) lie in the row
  const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
  unsigned long long crc = ~0ull;
  // bytes 2 and 3, the high half of word 0
  const uint32_t w0 = words[0];
  if (end > 2) crc = crc_byte(crc, (w0 >> 16) & 0xFF, tab);
  if (end > 3) crc = crc_byte(crc, w0 >> 24, tab);
  int pos = 4;
  for (; pos + 4 <= end; pos += 4) crc = crc_word(crc, words[pos >> 2], tab);
  if (pos < end) {  // a partial last word, one byte at a time
    const uint32_t w = words[pos >> 2];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (pos + i < end) crc = crc_byte(crc, (w >> (8 * i)) & 0xFF, tab);
    }
  }
  const uint32_t last = row[k - 1];
  for (int j = end - 2; j < n; ++j) crc = crc_byte(crc, last, tab);
  return static_cast<uint32_t>(~crc);
}

}  // namespace
