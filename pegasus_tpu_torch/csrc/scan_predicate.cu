// Scan predicate kernel for Hopper (sm_90a): one launch over a table of
// record blocks.
//
// Replaces the Pallas TPU kernel pegasus_tpu/ops/pallas_scan.py:_kernel
// (:43, launched through pl.pallas_call at :100) and carries the two XLA
// predicate programs of the serving path, _static_block_predicate
// (ops/predicates.py:196) and _scan_block_predicate (:160): it is their
// union, not a copy of the Pallas program's transposed [K+32, B] layout
// (a TPU lane trick) or its 32-byte pattern cap.
//
// The uint32 columns (expire_ts, hash_lo, pidx) arrive as int32 bit
// patterns, four bytes a record, and are read here as uint32_t.
// Per record b of a row-major block (keys uint8[B, K]):
//   expired      = has_now && valid && 0 < expire_ts <= now      (uint32)
//   hash_ok      = !validate || (hash_lo & pv) == pidx            (uint32)
//   hk_ok, sk_ok = FT_* match of the hashkey region [2, 2+hkl) and the
//                  sortkey region [2+hkl, key_len) against the patterns
//   status       = PAD (invalid row) | EXPIRED | HASH_INVALID | FILTERED
//                  | KEEP, in the reference's precedence
//                  (validate_key_value_for_scan, pegasus_server_impl.cpp:2382)
// With `now` the kernel writes that status byte per record (the merge
// path and the four ScanMasks read it). Without `now` (the static mask of
// the columnar path) it writes only the keep bit, packed as jnp.packbits
// packs it: big-endian within each byte, record 8j at bit 7 of byte j,
// each block's mask starting on a byte of its own.
//
// Bound on an H100 SXM (3.35 TB/s HBM): memory. Each input byte the call
// needs is read once: valid 1 B a record; hash_lo 4 B (and a per-record
// pidx 4 B when given) only with validation; expire_ts 4 B only with
// `now`; the key row K B and hashkey_len 4 B only when a hashkey or
// sortkey filter is set, key_len 4 B only with a sortkey filter. Output:
// 1 B a record with `now`, 1/8 B without. A serving call without a filter
// needs 6-14 B a record, so a merge batch (1 block of 1024) or a cold
// window (8 blocks of 1024) is a few nanoseconds of memory time against
// microseconds of launch latency: at main-path sizes launch latency, not
// bandwidth, bounds it. Large tables (the whole-table masks of later
// slices) are bandwidth-bound: about 45 B a record at K = 32 with a
// sortkey filter.
//
// Design, against each of those:
// - Launch latency: one launch covers a whole table of up to 16 blocks.
//   The table (every block's column pointers, scalar pidx or pidx column,
//   record count and output offset) travels by value as a
//   __grid_constant__ kernel parameter (about 1.3 KB, under the 4 KB
//   limit), so nothing is stacked, copied or allocated for it; the
//   flattened tile index picks the block. Packed output makes the copy
//   back to the host 1/8 B a record.
// - Bandwidth: a thread block takes a tile of 256 consecutive records of
//   one block, one thread each; the columns are read coalesced and all
//   issued before the key tile is waited on. The tile's key rows are one
//   contiguous range of 256 x K bytes, staged into shared memory with
//   16-byte loads, neighbouring threads on neighbouring addresses, at a
//   row stride of K + 4 bytes so that the threads of a warp reading the
//   same offset of their rows hit 32 different banks. Rows wider than
//   256 B are matched in place: such a row spans whole 32-byte sectors,
//   so reading it from global memory wastes none, and 256 of them would
//   not fit a block's shared memory. No key byte, key_len or hashkey_len
//   is read when no filter needs them.
// - Matching: PREFIX and POSTFIX compare 32-bit words (funnel-shifted
//   for unaligned regions) where the region lies inside the row; the
//   reference's clip(offs + j, 0, K-1) rule for malformed rows keeps its
//   exact byte loop on its own branch. ANYWHERE scans the region a word
//   at a time for the pattern's first byte (__vcmpeq4) and verifies only
//   those candidates, reading zeros past K. Patterns of any length stay
//   in global memory, read by every thread at the same address.
// - Packing: __ballot_sync gathers a warp's 32 keep bits, and four lanes
//   write the four bytes.
//
// The flavour axis (pegasus_scan_table_multi) carries the XLA program
// _multi_static_block_predicate (ops/predicates.py:539): the static keep
// masks of K filter flavours of one (hashkey, sortkey) filter-type pair
// over one table, written as K rows of packed masks. The point of the
// reference's one program for K flavours is kept: each key tile is read
// from HBM and staged once, `valid & hash_ok` is computed once per record
// (it does not depend on the flavour), and the K flavours are matched
// against the staged tile in a loop, each writing its ballot-packed bytes
// into its own row. Patterns and their lengths arrive in one device
// buffer and are read by every thread at the same address (broadcast
// through L1), so they take no shared memory beside the key tile. Bound:
// memory as above plus K/8 B of output a record; with many flavours over
// wide keys the match loop, K times the single-flavour work on the same
// staged bytes, bounds it instead.
//
// The key-hash instance (kHashKeys) carries the JAX package's
// ops/device_crc.py:65 `key_hash_device` for blocks without a stored hash:
// a block whose descriptor has no hash_lo column (a PGT1 file's) hashes
// its valid rows in the kernel when the table validates ownership, the
// lo lane of the crc64 of the hashkey region (the sortkey region when the
// hashkey is empty), read from the key row in place with the crc64 table
// staged in shared memory (key_hash.cuh, shared with the compaction
// kernel). Blocks of one table may mix stored and hashed columns. The
// instance is chosen on the host: only a validating table holding such a
// block takes it, so the other launches carry no crc loop. Bound: the
// key row K B, key_len and hashkey_len 4 B each a record are read
// besides the columns above, or about 8 integer operations a hashed byte
// where that is larger.

#include <cstdint>
#include <cuda_runtime.h>

// the byte matcher (load_word, equal_at, find_anywhere, match_region), the
// key-tile staging and the ballot packing, shared with compaction_filter.cu
#include "match.cuh"
// key_hash_lo and the crc64 table's staging, shared with
// compaction_filter.cu
#include "key_hash.cuh"

// Mirrored by _BlockDesc in ops/fused_scan.py; outside the anonymous
// namespace so that the exported entry point can name it.
struct BlockDesc {
  const uint8_t* keys;          // uint8[count, k]
  const int32_t* key_len;       // int32[count]
  const int32_t* hashkey_len;   // int32[count]
  const uint32_t* expire_ts;    // uint32 bits[count]
  const uint8_t* valid;         // bool[count]
  const uint32_t* hash_lo;      // uint32 bits[count], or null: no stored
                                // hash (the key-hash instance hashes)
  const uint32_t* pidx_col;     // uint32 bits[count], or null: `pidx`
  uint32_t pidx;
  int32_t count;
  int64_t out_offset;           // bytes into the output
  int32_t first_tile;           // set by the entry point
  int32_t reserved;
};
static_assert(sizeof(BlockDesc) == 80, "BlockDesc layout");

namespace {

constexpr uint8_t kPad = 0;
constexpr uint8_t kKeep = 1;
constexpr uint8_t kExpired = 2;
constexpr uint8_t kHashInvalid = 3;
constexpr uint8_t kFiltered = 4;

constexpr int kMaxBlocks = 16;        // blocks per table (STACK_CHUNK)

struct Table {
  BlockDesc blocks[kMaxBlocks];
  Filter hash;
  Filter sort;
  const unsigned long long* crc_tab;  // crc64 table[256], key-hash instance
  uint32_t pv;
  uint32_t now;
  int32_t n_blocks;
  int32_t k;
  int32_t k_shift;  // log2(k)
  int32_t validate;
  int32_t has_now;
};
static_assert(sizeof(Table) <= 4096, "kernel parameter limit");

// The block of the table this thread block's tile lies in.
__device__ __forceinline__ int tile_block(const BlockDesc* blocks,
                                          int n_blocks) {
  int bi = 0;
  while (bi + 1 < n_blocks &&
         static_cast<int>(blockIdx.x) >= blocks[bi + 1].first_tile) {
    ++bi;
  }
  return bi;
}

template <bool kHashKeys>
__global__ void __launch_bounds__(kTile)
    scan_table_kernel(const __grid_constant__ Table t,
                      uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t tile_keys[];
  __shared__ unsigned long long crc_tab[kHashKeys ? 256 : 1];
  if (kHashKeys) stage_crc_table(crc_tab, t.crc_tab);
  const BlockDesc& d = t.blocks[tile_block(t.blocks, t.n_blocks)];
  const int base = (static_cast<int>(blockIdx.x) - d.first_tile) * kTile;
  const int n = min(kTile, d.count - base);
  const int r = threadIdx.x;
  const bool live = r < n;
  const int b = base + r;
  const int k = t.k;
  const bool hash_f = t.hash.len > 0;
  const bool sort_f = t.sort.len > 0;
  const bool need_keys = hash_f || sort_f;

  // this block's rows are hashed here, not read from a stored column
  const bool hashed = kHashKeys && t.validate && d.hash_lo == nullptr;

  // every column load of the tile is in flight before the key tile is
  // waited on
  const uint8_t valid = live ? d.valid[b] : 0;
  const uint32_t ets = live && t.has_now ? d.expire_ts[b] : 0;
  const uint32_t hlo = live && t.validate && !hashed ? d.hash_lo[b] : 0;
  const uint32_t owner = d.pidx_col == nullptr
                             ? d.pidx
                             : (live && t.validate ? d.pidx_col[b] : 0);
  const int hkl = live && (need_keys || hashed) ? d.hashkey_len[b] : 0;
  const int klen = live && (sort_f || hashed) ? d.key_len[b] : 0;

  const bool staged = need_keys && k <= kMaxStagedWidth;
  const int stride = k + 4;
  if (staged) stage_keys(d.keys, base, n, k, t.k_shift, tile_keys);

  uint8_t status = kPad;
  if (live && valid) {
    const uint32_t lo =
        hashed ? key_hash_lo(d.keys + (static_cast<size_t>(b) << t.k_shift),
                             k, klen, hkl, crc_tab)
               : hlo;
    if (t.has_now && ets > 0 && ets <= t.now) {
      status = kExpired;
    } else if (t.validate && (lo & t.pv) != owner) {
      status = kHashInvalid;
    } else {
      bool ok = true;
      if (need_keys) {
        const uint8_t* row =
            staged ? tile_keys + r * stride
                   : d.keys + (static_cast<size_t>(b) << t.k_shift);
        ok = match_region(row, k, 2, hkl, t.hash) &&
             match_region(row, k, 2 + hkl, klen - 2 - hkl, t.sort);
      }
      status = ok ? kKeep : kFiltered;
    }
  }

  if (t.has_now) {
    if (live) out[d.out_offset + b] = status;
    return;
  }
  const unsigned bits = __ballot_sync(0xFFFFFFFFu, status == kKeep);
  // base + (r & ~31): the warp's first record
  write_packed(bits, base + (r & ~31), d.count, out + d.out_offset);
}

// The flavour axis: K filter flavours sharing one (hash, sort) filter
// type pair, patterns at hpats + f * hpitch and spats + f * spitch, their
// lengths at plens[f] (hashkey) and plens[n_flavors + f] (sortkey).
struct MultiTable {
  BlockDesc blocks[kMaxBlocks];
  const unsigned long long* crc_tab;  // crc64 table[256], key-hash instance
  const uint8_t* hpats;
  const uint8_t* spats;
  const int32_t* plens;
  int64_t row_bytes;  // one flavour's packed masks, block after block
  int32_t hpitch;
  int32_t spitch;
  int32_t hft;
  int32_t sft;
  int32_t n_flavors;
  uint32_t pv;
  int32_t n_blocks;
  int32_t k;
  int32_t k_shift;
  int32_t validate;
  int32_t need_hash;  // some flavour has a hashkey pattern
  int32_t need_sort;  // some flavour has a sortkey pattern
};
static_assert(sizeof(MultiTable) <= 4096, "kernel parameter limit");

template <bool kHashKeys>
__global__ void __launch_bounds__(kTile)
    scan_table_multi_kernel(const __grid_constant__ MultiTable t,
                            uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t tile_keys[];
  __shared__ unsigned long long crc_tab[kHashKeys ? 256 : 1];
  if (kHashKeys) stage_crc_table(crc_tab, t.crc_tab);
  const BlockDesc& d = t.blocks[tile_block(t.blocks, t.n_blocks)];
  const int base = (static_cast<int>(blockIdx.x) - d.first_tile) * kTile;
  const int n = min(kTile, d.count - base);
  const int r = threadIdx.x;
  const bool live = r < n;
  const int b = base + r;
  const int k = t.k;
  const bool need_keys = t.need_hash || t.need_sort;

  const bool hashed = kHashKeys && t.validate && d.hash_lo == nullptr;
  const uint8_t valid = live ? d.valid[b] : 0;
  const uint32_t hlo = live && t.validate && !hashed ? d.hash_lo[b] : 0;
  const uint32_t owner = d.pidx_col == nullptr
                             ? d.pidx
                             : (live && t.validate ? d.pidx_col[b] : 0);
  const int hkl = live && (need_keys || hashed) ? d.hashkey_len[b] : 0;
  const int klen = live && (t.need_sort || hashed) ? d.key_len[b] : 0;

  const bool staged = need_keys && k <= kMaxStagedWidth;
  if (staged) stage_keys(d.keys, base, n, k, t.k_shift, tile_keys);
  const uint8_t* row =
      staged ? tile_keys + r * (k + 4)
             : d.keys + (static_cast<size_t>(live ? b : 0) << t.k_shift);

  // flavour-independent: padding, invalid rows and foreign records fail
  // every flavour
  const uint32_t lo =
      hashed && live && valid
          ? key_hash_lo(d.keys + (static_cast<size_t>(b) << t.k_shift), k,
                        klen, hkl, crc_tab)
          : hlo;
  const bool base_ok =
      live && valid && (!t.validate || (lo & t.pv) == owner);
  const int first = base + (r & ~31);
  for (int f = 0; f < t.n_flavors; ++f) {
    bool ok = base_ok;
    if (ok && need_keys) {
      const Filter hf{t.hpats + static_cast<size_t>(f) * t.hpitch,
                      __ldg(t.plens + f), t.hft};
      const Filter sf{t.spats + static_cast<size_t>(f) * t.spitch,
                      __ldg(t.plens + t.n_flavors + f), t.sft};
      ok = match_region(row, k, 2, hkl, hf) &&
           match_region(row, k, 2 + hkl, klen - 2 - hkl, sf);
    }
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, ok);
    write_packed(bits, first, d.count,
                 out + f * t.row_bytes + d.out_offset);
  }
}

}  // namespace

// Launches one kernel over `n_blocks` (1..16) block descriptors on
// `stream` and returns cudaGetLastError() of the launch (0 on success),
// or cudaErrorInvalidValue for a table the kernel does not take. Every
// pointer is device memory. k is the table's key width, a power of two
// >= 32; hplen/splen count pattern bytes (0 for FT_NO_FILTER). `out`
// holds each block's bytes at its out_offset: `count` status bytes with
// `now`, ceil(count / 8) packed keep bytes without. A validating table
// holding a block without a hash_lo column launches the key-hash instance,
// which needs `crc_tab` (the crc64 table, 256 uint64 in device memory).
extern "C" int pegasus_scan_table(const BlockDesc* blocks, int n_blocks,
                                  int k, uint32_t pv, int validate, int hft,
                                  const uint8_t* hpat, int hplen, int sft,
                                  const uint8_t* spat, int splen,
                                  int has_now, uint32_t now, uint8_t* out,
                                  void* stream,
                                  const unsigned long long* crc_tab) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || k < 32 || (k & (k - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t{};
  int tiles = 0;
  bool hash_keys = false;
  for (int i = 0; i < n_blocks; ++i) {
    if (blocks[i].count < 0) return static_cast<int>(cudaErrorInvalidValue);
    t.blocks[i] = blocks[i];
    t.blocks[i].first_tile = tiles;
    tiles += (blocks[i].count + kTile - 1) / kTile;
    // an empty block's columns may be null: it has nothing to hash
    hash_keys |= validate && blocks[i].count > 0 &&
                 blocks[i].hash_lo == nullptr;
  }
  if (hash_keys && crc_tab == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return 0;
  t.crc_tab = crc_tab;
  t.hash = {hpat, hplen, hft};
  t.sort = {spat, splen, sft};
  t.pv = pv;
  t.now = now;
  t.n_blocks = n_blocks;
  t.k = k;
  t.k_shift = __builtin_ctz(static_cast<unsigned>(k));
  t.validate = validate;
  t.has_now = has_now;
  const bool staged = (hplen > 0 || splen > 0) && k <= kMaxStagedWidth;
  const size_t smem = staged ? static_cast<size_t>(kTile) * (k + 4) : 0;
  const auto kernel =
      hash_keys ? scan_table_kernel<true> : scan_table_kernel<false>;
  if (smem > 48 * 1024) {
    static bool raised[2] = {false, false};
    if (!raised[hash_keys]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[hash_keys] = true;
    }
  }
  kernel<<<tiles, kTile, smem, static_cast<cudaStream_t>(stream)>>>(t, out);
  return static_cast<int>(cudaGetLastError());
}

// Launches the flavour axis over `n_blocks` (1..16) block descriptors on
// `stream`: one kernel, `n_flavors` rows of `row_bytes` packed static keep
// bytes in `out`, each block's mask at its out_offset within every row.
// hpats/spats hold n_flavors patterns at a pitch of hpitch/spitch bytes
// (multiples of 4, zero-padded), plens their 2 * n_flavors lengths
// (hashkey, then sortkey; 0 for FT_NO_FILTER). All flavours share the
// filter types hft/sft. A validating table holding a block without a
// hash_lo column launches the key-hash instance (crc_tab as above).
// Returns cudaGetLastError() of the launch, or cudaErrorInvalidValue for
// a table the kernel does not take.
extern "C" int pegasus_scan_table_multi(
    const BlockDesc* blocks, int n_blocks, int k, uint32_t pv, int validate,
    int hft, const uint8_t* hpats, int hpitch, int sft,
    const uint8_t* spats, int spitch, const int32_t* plens, int n_flavors,
    int need_hash, int need_sort, int64_t row_bytes, uint8_t* out,
    void* stream, const unsigned long long* crc_tab) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || k < 32 || (k & (k - 1)) ||
      n_flavors < 1 || hpitch < 4 || (hpitch & 3) || spitch < 4 ||
      (spitch & 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MultiTable t{};
  int tiles = 0;
  bool hash_keys = false;
  for (int i = 0; i < n_blocks; ++i) {
    if (blocks[i].count < 0) return static_cast<int>(cudaErrorInvalidValue);
    t.blocks[i] = blocks[i];
    t.blocks[i].first_tile = tiles;
    tiles += (blocks[i].count + kTile - 1) / kTile;
    // an empty block's columns may be null: it has nothing to hash
    hash_keys |= validate && blocks[i].count > 0 &&
                 blocks[i].hash_lo == nullptr;
  }
  if (hash_keys && crc_tab == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return 0;
  t.crc_tab = crc_tab;
  t.hpats = hpats;
  t.spats = spats;
  t.plens = plens;
  t.row_bytes = row_bytes;
  t.hpitch = hpitch;
  t.spitch = spitch;
  t.hft = hft;
  t.sft = sft;
  t.n_flavors = n_flavors;
  t.pv = pv;
  t.n_blocks = n_blocks;
  t.k = k;
  t.k_shift = __builtin_ctz(static_cast<unsigned>(k));
  t.validate = validate;
  t.need_hash = need_hash;
  t.need_sort = need_sort;
  const bool staged = (need_hash || need_sort) && k <= kMaxStagedWidth;
  const size_t smem = staged ? static_cast<size_t>(kTile) * (k + 4) : 0;
  const auto kernel = hash_keys ? scan_table_multi_kernel<true>
                                : scan_table_multi_kernel<false>;
  if (smem > 48 * 1024) {
    static bool raised[2] = {false, false};
    if (!raised[hash_keys]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[hash_keys] = true;
    }
  }
  kernel<<<tiles, kTile, smem, static_cast<cudaStream_t>(stream)>>>(t, out);
  return static_cast<int>(cudaGetLastError());
}
