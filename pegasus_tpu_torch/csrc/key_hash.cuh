// The key hash of the JAX package's ops/device_crc.py:65
// `key_hash_device`, shared by the scan kernel (scan_predicate.cu, its
// key-hash instance) and the compaction kernel (compaction_filter.cu):
// the lo lane of pegasus_key_hash (src/base/pegasus_key_schema.h:150),
// the crc64 of the hashkey region of a padded key row, or of the sortkey
// region when the hashkey is empty. The plain version is
// ops/device_crc.key_hash_device.
//
// The crc64 table (256 entries, base/crc.py's TABLE64) arrives in device
// memory and is staged once a thread block into shared memory: every
// byte of the loop looks it up at a data-dependent index, and a shared
// lookup is one bank access where a global one is an L1 round trip.
// About 8 integer operations a hashed byte.

#pragma once

#include <cstdint>

// Copy the 256-entry crc64 table from `src` (device memory) into the
// block's shared `dst`, then wait for the block. Every thread of the
// block must call it.
__device__ __forceinline__ void stage_crc_table(
    unsigned long long* dst, const unsigned long long* src) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// The lo lane of key_hash_device over a 4-byte aligned key row of width
// k: crc64 over bytes [2, 2 + n), n = clip(hkl > 0 ? hkl : klen - 2, 0,
// k), bytes at or past k reading row[k - 1] (the JAX function's
// clip(start + j, 0, K - 1) gather over K steps). `tab` is the crc64
// table.
__device__ inline uint32_t key_hash_lo(
    const uint8_t* row, int k, int klen, int hkl,
    const unsigned long long* tab) {
  const int n = min(max(hkl > 0 ? hkl : klen - 2, 0), k);
  const int end = 2 + min(n, k - 2);  // bytes [2, end) lie in the row
  unsigned long long crc = ~0ull;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
  for (int w = 0; 4 * w < end; ++w) {
    const uint32_t v = words[w];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = 4 * w + i;
      if (pos >= 2 && pos < end) {
        crc = tab[(crc ^ (v >> (8 * i))) & 0xFF] ^ (crc >> 8);
      }
    }
  }
  const unsigned long long last = row[k - 1];
  for (int j = end - 2; j < n; ++j) {
    crc = tab[(crc ^ last) & 0xFF] ^ (crc >> 8);
  }
  return static_cast<uint32_t>(~crc);
}
