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
// from HBM and staged once, and `valid & hash_ok` is computed once a
// record. Bound on this card: memory, as above plus K/8 B of output a
// record (2^20 records, K = 32, 8 flavours: 14.40 us). PR 3's loop was
// bound by its instructions instead (50.93 us, 28.3%, PR 8's final run):
// every record and flavour rebuilt two Filters, loaded both lengths
// with __ldg, re-entered match_region's type dispatch and region
// bounds, compared short patterns a byte at a time, and ended in a
// ballot with a four-lane byte store; at 40 registers it held 75% of the
// SM's threads. The redesign (PR 9):
// - Once a record, not once a flavour: the columns, the ownership check
//   and both regions; the filter-type dispatch once a launch, in the
//   instance: kSortWindow for the pair phase 5 sends (no hashkey filter,
//   sortkey PREFIX or POSTFIX), kAnyPair (match_region) for the others.
// - Each flavour's lengths, output row and 8-byte window record are
//   staged once a thread block in shared memory and read as broadcast
//   words.
// - The window: the 8 bytes from the sortkey region's start (PREFIX) or
//   ending at its end (POSTFIX), three staged words funnel-shifted (a
//   byte gather at the reference's clip(offs + j, 0, K - 1) where the
//   window leaves the row), with the window's bytes outside the region
//   set. A pattern of up to 8 bytes is then ((win ^ pattern) | outside)
//   & mask == 0: no branch on its bytes, its length check included, an
//   empty pattern (mask 0) matching everything. The host stages such
//   flavours first (ops/fused_scan._pattern_buffer); longer ones take
//   the exact matcher in a second pass, and each flavour's row goes
//   where the caller put it.
// - Output: flavour f's ballot goes to lane f % 32, and after 32
//   flavours each lane stores its flavour's four bytes, one 4-byte store
//   where the row offset is aligned (a block's mask starts at any byte).
// - Registers: the window instance at 32 with no spill, every SM thread
//   resident; unrolling the flavour loop, or 40 registers at 75%
//   occupancy, measured slower.
// Times (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py --times-only,
// PR 8's tree and this one in turns on one card; PERF.md): 2^20
// records, 8 flavours, L2 flushed: PR 8 50.66 / 51.02 us, this design
// 28.40 / 28.58 us against 14.40 us (50.4-50.7%); a cold window of 16 x
// 1024 records, 4 flavours: 4.54 / 4.57 us, now 3.46 / 3.48 us.
//
// The key-hash instance (kHashKeys) carries the JAX package's
// ops/device_crc.py:65 `key_hash_device` for blocks without a stored hash:
// a block whose descriptor has no hash_lo column (a PGT1 file's) hashes
// its valid rows in the kernel when the table validates ownership, the
// lo lane of the crc64 of the hashkey region (the sortkey region when the
// hashkey is empty). Blocks of one table may mix stored and hashed
// columns. The instance is chosen on the host: only a validating table
// holding such a block takes it, so the other launches carry no crc loop.
// Bound: the key row K B, key_len and hashkey_len 4 B each a record are
// read besides the columns above (2^20 records, K = 32: 12.87 us). What
// bounds it in practice is the crc's table lookups, one 64-bit shared
// load a hashed byte. PR 8 hashed a byte at a time, a chain of dependent
// lookups (33.62 us, 38.3%, and a 4-byte spill). The redesign
// (key_hash.cuh, shared with the compaction kernel) hashes a word a
// step through 4 slicing tables, four independent lookups, reading the
// row in place a word at a time (the first load of a row brings its
// sector into L1); the tables (8 KB) are staged once a thread block.
// Staging the key tile, slicing by 8 (16 KB of tables), rows as 16-byte
// loads into registers, tables derived in the block and conflict-free
// nibble tables (twice the lookups) all measured slower in the design
// runs. Times (as above): PR 8 33.77 / 33.80 us, this design 28.72 /
// 27.72 us against 12.87 us (45-46%); the stored-hash kernel reading
// the same rows for a sortkey PREFIX takes 23.4-23.6 us, so the lookups
// cost the rest. The multi instances with the crc loop run at 4 blocks
// an SM, 48 registers, without a spill.

#include <cstdint>
#include <cuda_runtime.h>

// the byte matcher (load_word, equal_at, find_anywhere, match_fixed,
// match_region), the key-tile staging and the ballot packing, shared with
// compaction_filter.cu
#include "match.cuh"
// key_hash_lo and the crc64 tables' staging, shared with
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
constexpr int kNoFilter = 0;          // FT_NO_FILTER
// flavours of one flavour-axis launch (their lengths and windows are
// staged in shared memory beside the key tile)
constexpr int kMaxFlavors = 4096;
// dynamic shared memory a launch may take: the widest staged key tile
// and the flavours' table, with the crc64 tables' static 8 KB beside it
// within the block's 227 KB
constexpr int kSmemOptIn = 200 * 1024;

struct Table {
  BlockDesc blocks[kMaxBlocks];
  Filter hash;
  Filter sort;
  const unsigned long long* crc_tab;  // slicing tables, key-hash instance
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

// Opt a kernel in to kSmemOptIn bytes of dynamic shared memory, once.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (err == cudaSuccess) *done = true;
  return err;
}

template <bool kHashKeys>
__global__ void __launch_bounds__(kTile)
    scan_table_kernel(const __grid_constant__ Table t,
                      uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t tile_keys[];
  __shared__ __align__(16) unsigned long long crc_tab[kHashKeys ? kCrcWords
                                                                : 2];
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

  // the key tile is staged for a filter; the key hash reads the staged
  // row, or the row in place when no filter staged it
  const bool staged = need_keys && k <= kMaxStagedWidth;
  const int stride = k + 4;
  if (kHashKeys) stage_crc_tables(crc_tab, t.crc_tab);
  if (staged) stage_keys(d.keys, base, n, k, t.k_shift, tile_keys);
  if (kHashKeys || staged) __syncthreads();

  uint8_t status = kPad;
  if (live && valid) {
    // (computed here, not for every thread: at K = 256 the other place
    // measured slower)
    const uint8_t* row =
        staged ? tile_keys + r * stride
               : d.keys + (static_cast<size_t>(b) << t.k_shift);
    const uint32_t lo = hashed ? key_hash_lo(row, k, klen, hkl, crc_tab)
                               : hlo;
    if (t.has_now && ets > 0 && ets <= t.now) {
      status = kExpired;
    } else if (t.validate && (lo & t.pv) != owner) {
      status = kHashInvalid;
    } else {
      bool ok = true;
      if (need_keys) {
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
// type pair. Staged flavour f's patterns lie at hpats + f * hpitch and
// spats + f * spitch, its lengths (hashkey, sortkey) at lens[f], its
// output row at perm[f]; the first n_short flavours (sortkey patterns of
// up to 8 bytes, for the window instance) also have a window record
// (pattern lo, hi, mask lo, hi) at windows[f].
struct MultiTable {
  BlockDesc blocks[kMaxBlocks];
  const unsigned long long* crc_tab;  // slicing tables, key-hash instance
  const uint8_t* hpats;
  const uint8_t* spats;
  const int2* lens;
  const uint4* windows;
  const int32_t* perm;
  int64_t row_bytes;  // one flavour's packed masks, block after block
  int32_t hpitch;
  int32_t spitch;
  int32_t hft;
  int32_t sft;
  int32_t n_flavors;
  int32_t n_short;
  uint32_t pv;
  int32_t n_blocks;
  int32_t k;
  int32_t k_shift;
  int32_t validate;
  int32_t need_hash;  // some flavour has a hashkey pattern
  int32_t need_sort;  // some flavour has a sortkey pattern
};
static_assert(sizeof(MultiTable) <= 4096, "kernel parameter limit");

// Instances of the flavour axis by filter type pair: any pair through
// match_region, or hashkey FT_NO_FILTER with sortkey PREFIX or POSTFIX
// (what phase 5's scans send) through the 8-byte sortkey window.
constexpr int kAnyPair = 0;
constexpr int kSortWindow = 1;

// The masks of flavours [lo, hi) for the warp's 32 records: flavour f's
// ballot of match(f) goes to lane f % 32, and after 32 flavours each lane
// writes its flavour's four bytes into row perm[f] (one store where
// aligned).
template <typename Match>
__device__ __forceinline__ void flavour_rows(int lo, int hi,
                                             const int32_t* perm,
                                             int64_t row_bytes, int first,
                                             int count, uint8_t* out_block,
                                             Match match) {
  const int lane = threadIdx.x & 31;
  for (int f0 = lo; f0 < hi; f0 += 32) {
    const int fn = min(32, hi - f0);
    unsigned mine = 0;
    // not unrolled: unrolled by 4 or 8 the window instance spilled at 32
    // registers and ran slower
#pragma unroll 1
    for (int j = 0; j < fn; ++j) {
      const unsigned bits = __ballot_sync(0xFFFFFFFFu, match(f0 + j));
      if (lane == j) mine = bits;
    }
    if (lane < fn) {
      write_packed_lane(mine, first, count,
                        out_block + static_cast<int64_t>(perm[f0 + lane]) *
                                        row_bytes);
    }
  }
}

// One tile of the flavour axis (the body of its kernels).
template <bool kHashKeys, int kPath>
__device__ __forceinline__ void multi_tile(const MultiTable& t,
                                           uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(16) unsigned long long crc_tab[kHashKeys ? kCrcWords
                                                                : 2];
  const BlockDesc& d = t.blocks[tile_block(t.blocks, t.n_blocks)];
  const int base = (static_cast<int>(blockIdx.x) - d.first_tile) * kTile;
  const int n = min(kTile, d.count - base);
  const int r = threadIdx.x;
  const bool live = r < n;
  const int b = base + r;
  const int k = t.k;
  const bool need_keys = t.need_hash || t.need_sort;

  // flavour-independent, once a record: the columns, the ownership
  // check and both regions
  const bool hashed = kHashKeys && t.validate && d.hash_lo == nullptr;
  const uint8_t valid = live ? d.valid[b] : 0;
  const uint32_t hlo = live && t.validate && !hashed ? d.hash_lo[b] : 0;
  const uint32_t owner = d.pidx_col == nullptr
                             ? d.pidx
                             : (live && t.validate ? d.pidx_col[b] : 0);
  const int hkl = live && (need_keys || hashed) ? d.hashkey_len[b] : 0;
  const int klen = live && (t.need_sort || hashed) ? d.key_len[b] : 0;

  // shared memory: the key tile (when staged), then the flavours'
  // windows, lengths and rows, read by every thread at one address
  const bool staged = need_keys && k <= kMaxStagedWidth;
  const int n_short = kPath == kSortWindow ? t.n_short : 0;
  uint4* windows =
      reinterpret_cast<uint4*>(smem + (staged ? kTile * (k + 4) : 0));
  int2* lens = reinterpret_cast<int2*>(windows + n_short);
  int32_t* perm = reinterpret_cast<int32_t*>(lens + t.n_flavors);
  for (int f = r; f < t.n_flavors; f += kTile) {
    if (f < n_short) windows[f] = t.windows[f];
    lens[f] = t.lens[f];
    perm[f] = t.perm[f];
  }
  if (kHashKeys) stage_crc_tables(crc_tab, t.crc_tab);
  if (staged) stage_keys(d.keys, base, n, k, t.k_shift, smem);
  __syncthreads();
  const uint8_t* row =
      staged ? smem + r * (k + 4)
             : d.keys + (static_cast<size_t>(live ? b : 0) << t.k_shift);

  const uint32_t lo =
      hashed && live && valid ? key_hash_lo(row, k, klen, hkl, crc_tab) : hlo;
  const bool base_ok =
      live && valid && (!t.validate || (lo & t.pv) == owner);
  const int sstart = 2 + hkl;
  const int slen = klen - 2 - hkl;

  // The sortkey window: the 8 bytes from the region's start (PREFIX) or
  // ending at its end (POSTFIX), byte i at row[clip(ws + i, 0, K - 1)]
  // as the reference reads a pattern's bytes, little-endian: inside the
  // row three staged words funnel-shifted, else (short or malformed
  // rows) gathered a byte at a time. `outside` sets the window's bytes
  // that lie outside the region, so that a pattern longer than the
  // region (its mask reaching past the region's bytes) fails; an empty
  // pattern (mask 0) matches everything. A flavour is then
  // ((win ^ pattern) | outside) & mask == 0, two words of three-input
  // logic.
  uint32_t win_lo = 0, win_hi = 0, out_lo = 0, out_hi = 0;
  if (kPath == kSortWindow) {
    const bool postfix = t.sft == kPostfix;
    const int ws = postfix ? klen - 8 : sstart;
    if (ws >= 0 && ws + 8 <= k) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (ws >> 2);
      const int sh = (ws & 3) * 8;
      const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
      win_lo = __funnelshift_r(w0, w1, sh);
      win_hi = __funnelshift_r(w1, w2, sh);
    } else {
      for (int i = 3; i >= 0; --i) {
        win_lo = (win_lo << 8) | row[min(max(ws + i, 0), k - 1)];
        win_hi = (win_hi << 8) | row[min(max(ws + 4 + i, 0), k - 1)];
      }
    }
    const int c = min(max(slen, 0), 8);  // the region's bytes in it
    const unsigned long long region =
        c == 0    ? 0ull
        : postfix ? ~0ull << (64 - 8 * c)
                  : ~0ull >> (64 - 8 * c);
    out_lo = ~static_cast<uint32_t>(region);
    out_hi = ~static_cast<uint32_t>(region >> 32);
  }

  const int first = base + (r & ~31);  // the warp's first record
  uint8_t* const out_block = out + d.out_offset;
  // flavours [0, n_short): one masked xor each against the window
  flavour_rows(
      0, n_short, perm, t.row_bytes, first, d.count, out_block,
      [&](int f) {
        const uint4 pm = windows[f];
        return base_ok && ((((win_lo ^ pm.x) | out_lo) & pm.z) |
                           (((win_hi ^ pm.y) | out_hi) & pm.w)) == 0;
      });
  // flavours [n_short, n_flavors): the exact matcher
  flavour_rows(
      n_short, t.n_flavors, perm, t.row_bytes, first, d.count, out_block,
      [&](int f) {
        if (!base_ok) return false;
        const int2 len = lens[f];
        if (kPath == kSortWindow) {
          return slen >= len.y &&
                 match_fixed(row, k,
                             t.sft == kPrefix ? sstart : klen - len.y,
                             t.spats + static_cast<size_t>(f) * t.spitch,
                             len.y);
        }
        const Filter hf{t.hpats + static_cast<size_t>(f) * t.hpitch, len.x,
                        t.hft};
        const Filter sf{t.spats + static_cast<size_t>(f) * t.spitch, len.y,
                        t.sft};
        return match_region(row, k, 2, hkl, hf) &&
               match_region(row, k, sstart, slen, sf);
      });
}

// The stored-hash instances, at the compiler's register budget (no spill).
template <int kPath>
__global__ void __launch_bounds__(kTile)
    scan_table_multi_kernel(const __grid_constant__ MultiTable t,
                            uint8_t* __restrict__ out) {
  multi_tile<false, kPath>(t, out);
}

// The key-hash instances, at 4 blocks an SM: the crc loop beside the
// flavour loop needs more than 32 registers, and a spill measured slower.
template <int kPath>
__global__ void __launch_bounds__(kTile, 4)
    scan_table_multi_keyhash_kernel(const __grid_constant__ MultiTable t,
                                    uint8_t* __restrict__ out) {
  multi_tile<true, kPath>(t, out);
}

// Copy a table's `n_blocks` descriptors into `dst`, each with its first
// tile. Returns the table's tiles, or -1 for a block the kernel does not
// take; *hash_keys tells whether a validating table holds a non-empty
// block without a hash_lo column (an empty block's columns may be null:
// it has nothing to hash).
int place_blocks(const BlockDesc* blocks, int n_blocks, int validate,
                 BlockDesc* dst, bool* hash_keys) {
  int tiles = 0;
  *hash_keys = false;
  for (int i = 0; i < n_blocks; ++i) {
    if (blocks[i].count < 0) return -1;
    dst[i] = blocks[i];
    dst[i].first_tile = tiles;
    tiles += (blocks[i].count + kTile - 1) / kTile;
    *hash_keys |= validate && blocks[i].count > 0 &&
                  blocks[i].hash_lo == nullptr;
  }
  return tiles;
}

// dynamic shared memory a launch may take without opting in: 48 KB less
// the key-hash instances' static crc64 tables
constexpr size_t kSmemDefault = 48 * 1024 - kCrcWords * 8;

}  // namespace

// The arguments of pegasus_scan_table beside its block descriptors, one
// struct so that a launch from Python converts one argument, not 16.
// Mirrored by _TABLE_ARGS in ops/fused_scan.py.
struct TableArgs {
  const uint8_t* hpat;   // hashkey pattern, 4-byte aligned, zero-padded
  const uint8_t* spat;   // sortkey pattern, the same
  uint8_t* out;
  void* stream;
  const unsigned long long* crc_tab;  // with a block to hash, else null
  uint32_t pv;
  uint32_t now;
  int32_t n_blocks;
  int32_t k;
  int32_t validate;
  int32_t hft;
  int32_t hplen;  // pattern bytes, 0 for FT_NO_FILTER
  int32_t sft;
  int32_t splen;
  int32_t has_now;
};
static_assert(sizeof(TableArgs) == 80, "TableArgs layout");

// The arguments of pegasus_scan_table_multi beside its block
// descriptors. Mirrored by _MULTI_ARGS in ops/fused_scan.py.
struct MultiArgs {
  const uint8_t* hpats;
  const uint8_t* spats;
  const int32_t* lens;
  const uint32_t* windows;
  const int32_t* perm;
  uint8_t* out;
  void* stream;
  const unsigned long long* crc_tab;
  int64_t row_bytes;
  uint32_t pv;
  int32_t n_blocks;
  int32_t k;
  int32_t validate;
  int32_t hft;
  int32_t hpitch;
  int32_t sft;
  int32_t spitch;
  int32_t n_flavors;
  int32_t n_short;
  int32_t need_hash;
  int32_t need_sort;
};
static_assert(sizeof(MultiArgs) == 120, "MultiArgs layout");

// Launches one kernel over a.n_blocks (1..16) block descriptors on
// a.stream and returns cudaGetLastError() of the launch (0 on success),
// or cudaErrorInvalidValue for a table the kernel does not take. Every
// pointer is device memory. a.k is the table's key width, a power of two
// >= 32. `out` holds each block's bytes at its out_offset: `count` status
// bytes with `now`, ceil(count / 8) packed keep bytes without. A
// validating table holding a block without a hash_lo column launches the
// key-hash instance, which needs `crc_tab` (the crc64 slicing tables,
// kCrcSlices x 256 uint64 in device memory, 16-byte aligned).
extern "C" int pegasus_scan_table(const TableArgs* a,
                                  const BlockDesc* blocks) {
  const int k = a->k;
  if (a->n_blocks < 1 || a->n_blocks > kMaxBlocks || k < 32 ||
      (k & (k - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t{};
  bool hash_keys = false;
  const int tiles = place_blocks(blocks, a->n_blocks, a->validate, t.blocks,
                                 &hash_keys);
  if (tiles < 0 || (hash_keys && a->crc_tab == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return 0;
  t.crc_tab = a->crc_tab;
  t.hash = {a->hpat, a->hplen, a->hft};
  t.sort = {a->spat, a->splen, a->sft};
  t.pv = a->pv;
  t.now = a->now;
  t.n_blocks = a->n_blocks;
  t.k = k;
  t.k_shift = __builtin_ctz(static_cast<unsigned>(k));
  t.validate = a->validate;
  t.has_now = a->has_now;
  const bool staged =
      (a->hplen > 0 || a->splen > 0) && k <= kMaxStagedWidth;
  const size_t smem = staged ? static_cast<size_t>(kTile) * (k + 4) : 0;
  const auto kernel =
      hash_keys ? scan_table_kernel<true> : scan_table_kernel<false>;
  if (smem > kSmemDefault) {
    static bool opted[2] = {false, false};
    const cudaError_t err = opt_in_smem(kernel, &opted[hash_keys]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<tiles, kTile, smem, static_cast<cudaStream_t>(a->stream)>>>(
      t, a->out);
  return static_cast<int>(cudaGetLastError());
}

// Launches the flavour axis over a.n_blocks (1..16) block descriptors on
// a.stream: one kernel, a.n_flavors (1..kMaxFlavors) rows of a.row_bytes
// packed static keep bytes in `out`, each block's mask at its out_offset
// within every row. The flavours arrive in a staged order: staged
// flavour f has its patterns at hpats + f * hpitch and spats + f * spitch
// (pitches multiples of 4, zero-padded), its (hashkey, sortkey) lengths
// as two int32 at lens + 2 f (0 for FT_NO_FILTER), its output row at
// perm[f]; for a sortkey PREFIX or POSTFIX pair without a hashkey filter
// the first n_short staged flavours are those of at most 8 sortkey
// bytes, with four uint32 at windows + 4 f (16-byte aligned): the
// pattern's bytes where the region's first (PREFIX) or last (POSTFIX) 8
// bytes hold them, lo and hi, and the mask of those bytes, lo and hi.
// All flavours share the filter types hft/sft. A validating table
// holding a block without a hash_lo column launches the key-hash
// instance (crc_tab as above). Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a table the kernel does not take.
extern "C" int pegasus_scan_table_multi(const MultiArgs* a,
                                        const BlockDesc* blocks) {
  const int k = a->k;
  const int n_flavors = a->n_flavors;
  if (a->n_blocks < 1 || a->n_blocks > kMaxBlocks || k < 32 ||
      (k & (k - 1)) || n_flavors < 1 || n_flavors > kMaxFlavors ||
      a->n_short < 0 || a->n_short > n_flavors || a->hpitch < 4 ||
      (a->hpitch & 3) || a->spitch < 4 || (a->spitch & 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MultiTable t{};
  bool hash_keys = false;
  const int tiles = place_blocks(blocks, a->n_blocks, a->validate, t.blocks,
                                 &hash_keys);
  if (tiles < 0 || (hash_keys && a->crc_tab == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles == 0) return 0;
  t.crc_tab = a->crc_tab;
  t.hpats = a->hpats;
  t.spats = a->spats;
  t.lens = reinterpret_cast<const int2*>(a->lens);
  t.windows = reinterpret_cast<const uint4*>(a->windows);
  t.perm = a->perm;
  t.row_bytes = a->row_bytes;
  t.hpitch = a->hpitch;
  t.spitch = a->spitch;
  t.hft = a->hft;
  t.sft = a->sft;
  t.n_flavors = n_flavors;
  t.pv = a->pv;
  t.n_blocks = a->n_blocks;
  t.k = k;
  t.k_shift = __builtin_ctz(static_cast<unsigned>(k));
  t.validate = a->validate;
  t.need_hash = a->need_hash;
  t.need_sort = a->need_sort;
  const bool staged = (a->need_hash || a->need_sort) && k <= kMaxStagedWidth;
  // the sortkey window reads the staged tile
  const bool window = a->hft == kNoFilter &&
                      (a->sft == kPrefix || a->sft == kPostfix) &&
                      a->need_sort && staged;
  t.n_short = window ? a->n_short : 0;
  const size_t smem =
      (staged ? static_cast<size_t>(kTile) * (k + 4) : 0) +
      static_cast<size_t>(t.n_short) * sizeof(uint4) +
      static_cast<size_t>(n_flavors) * (sizeof(int2) + sizeof(int32_t));
  if (smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  const int which = (hash_keys ? 2 : 0) + (window ? 1 : 0);
  const auto kernel =
      which == 3   ? scan_table_multi_keyhash_kernel<kSortWindow>
      : which == 2 ? scan_table_multi_keyhash_kernel<kAnyPair>
      : which == 1 ? scan_table_multi_kernel<kSortWindow>
                   : scan_table_multi_kernel<kAnyPair>;
  if (smem > kSmemDefault) {
    static bool opted[4] = {false, false, false, false};
    const cudaError_t err = opt_in_smem(kernel, &opted[which]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<tiles, kTile, smem, static_cast<cudaStream_t>(a->stream)>>>(
      t, a->out);
  return static_cast<int>(cudaGetLastError());
}
