// Compaction-filter kernel for Hopper (sm_90a): one launch over a chunk of
// padded record rows.
//
// Replaces the JAX package's fused compaction program
// pegasus_tpu/ops/compaction.py:110 `eval_block` (one XLA program per
// ruleset), with the user rules of ops/compaction_rules.py:134
// `apply_rules_ops` and, for rows without a stored hash, the key hash of
// ops/device_crc.py:65 `key_hash_device` inside it. It is not a Pallas
// kernel: XLA fused that program on the TPU, and this kernel is its
// hand-written counterpart. The reference order of
// KeyWithTTLCompactionFilter::Filter (key_ttl_compaction_filter.h:55-121)
// per row b, all uint32 arithmetic wrapping at 2^32:
//   ets1  = default_ttl != 0 && expire_ts == 0 ? now + default_ttl : expire_ts
//   rules = the operations in order; an operation matches where the row
//           is valid, not yet deleted, and every one of its rules holds,
//           each rule judged against ets1 (the pre-rules TTL):
//             hashkey/sortkey pattern: match_region over [2, 2 + hkl) or
//               [2 + hkl, key_len), hkl the key's big-endian u16 prefix
//               (0 where key_len is 0); an empty pattern matches nothing
//             ttl_range: ets1 == 0 ? start == stop == 0
//                        : now + start <= ets1 <= now + stop
//           delete_key drops the row (the first matching delete wins);
//           update_ttl sets ets2 to now + v (FROM_NOW), ets1 + v where
//           ets1 != 0 (FROM_CURRENT), or v (TIMESTAMP, precomputed)
//   lo    = hash_lo[b], or with kHashKeys the lo lane of the crc64 of the
//           key bytes [2, 2 + n), n = clip(hkl > 0 ? hkl : key_len - 2,
//           0, K), bytes at or past K reading key[K - 1] (key_hash_device)
//   stale = validate && (lo & pv) != pidx, and with kSlotGate also
//           slot_allowed[b >> slot_shift] (the resident image's per-slot
//           gate: pegasus_tpu/ops/compaction.py:219-221 `mesh_compact_step`,
//           a slot being one partition's 2^slot_shift rows)
//   drop  = ((expire && 0 < ets2 <= now) || stale) && valid) || rule_drop
// With kSlotGate the same launch is the resident image's compaction filter
// (pegasus_tpu/ops/compaction.py:178 `mesh_compact_step`, an XLA program
// on the TPU): the [P, B] image flattened to P * B rows, `present` as
// `valid`, the resident hash_lo, the per-slot gate, and pidx per slot
// (pidx_col[b >> slot_shift]: the owner is read once a slot, not a row);
// without the flag every instance computes what it did.
// It writes the drop mask, one byte a row or bit-packed in jnp.packbits'
// big-endian order, and ets2 when asked. The same kernel carries the merge
// path's filter (no rules) and its rules hook (`expire` off, no
// validation), so every compaction filter on the card is this launch.
//
// The ruleset is a small descriptor table (kMaxOps operations, kMaxRules
// rules) passed by value as a __grid_constant__ parameter; its patterns
// lie in one device buffer, 4-byte aligned, read by every thread at the
// same address (broadcast through L1).
//
// Bound on an H100 SXM (3.35 TB/s HBM): memory. Each input byte the call
// needs is read once: valid 1 B and expire_ts 4 B a row always; the key
// row K B and key_len 4 B when a pattern rule or the key hash reads it;
// hash_lo 4 B (unless the kernel hashes the keys) and a per-row pidx 4 B
// with validation (with kSlotGate a slot's pidx 4 B and allowed 1 B
// instead, read once a slot). Output: 1/8 B a row packed (1 B unpacked), ets2 4 B
// when asked. BASELINE config #4's ruleset at K = 32, packed, without
// validation or ets2 moves 41.125 B a row: 2^18 rows in about 3.2 us. The
// key hash is about 8 integer operations a hashed byte; a ruleset heavy
// in ANYWHERE patterns over wide keys is bound by its match loop.
//
// Design, against that bound (the card's times are in PERF.md). One
// block of 256 rows a tile, at no more than 32 registers, so that 8
// blocks fill an SM's 2048 threads: the kernel is latency-bound, and
// capped at fewer blocks an SM it measured slower. Each thread loads its
// row's columns, then reads its key row in place: a warp's first load of
// its rows brings them into L1 and its later loads hit there, so a warp
// matches as soon as its own rows arrive, with no block-wide staging and
// no barrier. (Staging each tile's key rows in shared memory behind a
// barrier, the first design, measured slower at K = 32 and K = 256, where
// the staged tile also cut the blocks an SM.) Three instances, chosen on
// the host from the flags: the row columns only (the merge path's filter,
// TTL-only chunks: no matcher), with the key rows (pattern rules), and
// with the key rows hashed for validation (kHashKeys), so that only the
// last carries the crc64 loop. The key hash (key_hash_device, in
// key_hash.cuh, shared with the scan kernel) reads the row in place a
// word at a time, each word one step of four independent lookups in the
// crc64 slicing tables (4 x 256 entries), staged once a block in shared
// memory; PR 9 moved it from a byte at a time over one table, and
// instance (iv) (chip_smoke.COMPACT_TIMED_SHAPES) went from 13.70 /
// 13.68 us to 13.05 / 13.06 us (NVIDIA H100 80GB HBM3, 700.00 W, the two
// trees in turns on one card; PERF.md). The byte matcher is match.cuh's, shared
// with the scan kernel. The packed mask comes from __ballot_sync, four
// lanes writing a warp's four bytes.
//
// The resident image's TTL pass (mesh_compact_step with no ruleset and
// validation against the resident hash_lo) has a kernel of its own,
// slot_gate_kernel: the same order (default-TTL rewrite, then expiry and
// the slot-gated stale-split drop) over 8 rows a thread. Bound: memory,
// 9.125 B a row (expire_ts 4, hash_lo 4, valid 1, 1/8 out) plus 5 B a
// slot, 4 B more a row with ets2: 2^20 rows in about 2.86 us. filter_tile
// takes a row a thread with byte loads of `valid` and measured 8.48 us
// there (PERF.md), held by per-row latency. Here every warp instruction
// reads contiguous bytes: expire_ts and hash_lo 16 bytes a lane (rows
// 128 i + 4 lane .. + 3 in instruction i), `valid` 8 bytes a lane (the 8
// rows of the mask byte the lane owns). The lane that loads 4 rows judges
// them and their drop nibbles reach the owning lane by two shuffles; the
// packed byte is built in registers and stored, and ets2 goes out as one
// 16-byte store a load. A block of 2048 rows inside one slot reads the
// slot's pidx and allowed once (a broadcast); a smaller slot reads them
// for each 4-row load. Two tiles a warp, and blocks of 1024 threads,
// measured no faster (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "key_hash.cuh"  // key_hash_lo and the crc64 tables' staging
#include "match.cuh"

// Mirrored by _RULE and _OP in ops/fused_compaction.py.
struct RuleDesc {
  int32_t kind;       // kHashkey, kSortkey, kTtlRange or kNever
  int32_t match;      // pattern rules: FT_* type; ttl_range: start == stop == 0
  int32_t pat_off;    // byte offset into the pattern buffer (multiple of 4)
  int32_t pat_len;    // > 0
  uint32_t start_ttl;
  uint32_t stop_ttl;
};
static_assert(sizeof(RuleDesc) == 24, "RuleDesc layout");

struct OpDesc {
  int32_t op;          // kDelete or kUpdate
  int32_t utot;        // kFromNow, kFromCurrent or kTimestamp
  uint32_t value;      // the update's value (TIMESTAMP: the expire_ts)
  int32_t first_rule;  // the operation's rules are [first, first + n)
  int32_t n_rules;
};
static_assert(sizeof(OpDesc) == 20, "OpDesc layout");

namespace {

constexpr int kMaxOps = 16;
constexpr int kMaxRules = 64;

constexpr int kHashkey = 0;
constexpr int kSortkey = 1;
constexpr int kTtlRange = 2;

constexpr int kDelete = 0;
constexpr int kFromNow = 0;
constexpr int kFromCurrent = 1;

// flag bits of the entry point
constexpr int kValidate = 1;
constexpr int kExpire = 2;
constexpr int kWantEts = 4;
constexpr int kPack = 8;
constexpr int kNeedKeys = 16;
constexpr int kHashKeys = 32;
constexpr int kSlotGate = 64;

// blocks an SM the register budget is set for: 8 x 256 threads is the
// SM's whole thread count, and every warp of it hides load latency
constexpr int kMinBlocksPerSm = 8;


struct Params {
  OpDesc ops[kMaxOps];
  RuleDesc rules[kMaxRules];
  const uint8_t* keys;          // uint8[n, k]
  const int32_t* key_len;       // int32[n]
  const uint32_t* expire_ts;    // uint32 bits[n]
  const uint8_t* valid;         // bool[n]
  const uint32_t* hash_lo;      // uint32 bits[n]
  const uint32_t* pidx_col;     // uint32 bits[n] (a slot's with
                                // kSlotGate), or null: `pidx`
  const uint8_t* pats;
  const unsigned long long* crc_tab;  // slicing tables with kHashKeys
  const uint8_t* slot_allowed;  // uint8[n >> slot_shift] with kSlotGate
  uint8_t* drop_out;            // n bytes, or ceil(n / 8) packed
  uint32_t* ets_out;            // uint32[n] when asked
  int64_t n;
  uint32_t pidx;
  uint32_t now;
  uint32_t default_ttl;
  uint32_t pv;
  int32_t k;
  int32_t k_shift;
  int32_t n_ops;
  int32_t flags;
  int32_t slot_shift;
};
static_assert(sizeof(Params) <= 4096, "kernel parameter limit");

// What a launch reads, one kernel instance each: the row columns only
// (the merge path's filter, TTL-only chunks: no rule reads a key byte);
// the key rows too (kNeedKeys); and the key rows hashed for validation
// (kHashKeys).
constexpr int kColumns = 0;
constexpr int kKeyRows = 1;
constexpr int kKeyHash = 2;

template <int kMode>
__device__ __forceinline__ bool rule_holds(const Params& p,
                                           const RuleDesc& rd,
                                           const uint8_t* row, int hkl,
                                           int klen, uint32_t ets) {
  if (kMode != kColumns && (rd.kind == kHashkey || rd.kind == kSortkey)) {
    const Filter f{p.pats + rd.pat_off, rd.pat_len, rd.match};
    return rd.kind == kHashkey
               ? match_region(row, p.k, 2, hkl, f)
               : match_region(row, p.k, 2 + hkl, klen - 2 - hkl, f);
  }
  if (rd.kind == kTtlRange) {
    if (ets == 0) return rd.match != 0;
    return ets >= p.now + rd.start_ttl && ets <= p.now + rd.stop_ttl;
  }
  return false;  // kNever: an empty pattern
}

// Evaluate row threadIdx.x of tile t, its key row read in place.
template <int kMode>
__device__ __forceinline__ void filter_tile(const Params& p, int64_t t,
                                            const unsigned long long* tab) {
  const int64_t base = t * kTile;
  const int64_t left = p.n - base;
  const int n = left < kTile ? static_cast<int>(left) : kTile;
  const int r = threadIdx.x;
  const bool live = r < n;
  const int64_t b = base + r;
  constexpr bool kKeys = kMode != kColumns;
  const bool validate = p.flags & kValidate;

  // every column load of the row is in flight before its key row is
  // waited on
  const uint8_t valid = live ? p.valid[b] : 0;
  const uint32_t ets0 = live ? p.expire_ts[b] : 0;
  const uint32_t hlo =
      kMode != kKeyHash && live && validate ? p.hash_lo[b] : 0;
  const int64_t owner_at = (p.flags & kSlotGate) ? b >> p.slot_shift : b;
  const uint32_t owner = p.pidx_col == nullptr
                             ? p.pidx
                             : (live && validate ? p.pidx_col[owner_at] : 0);
  const int klen = kKeys && live ? p.key_len[b] : 0;

  const uint8_t* row =
      p.keys + (static_cast<size_t>(kKeys && live ? b : 0) << p.k_shift);
  // the big-endian u16 hashkey length at the head of every key row
  const int hkl = klen > 0 ? (row[0] << 8) | row[1] : 0;

  const uint32_t ets1 =
      p.default_ttl != 0 && ets0 == 0 ? p.now + p.default_ttl : ets0;
  uint32_t ets2 = ets1;
  bool rule_drop = false;
  bool stale = false;
  if (live && valid) {
    for (int o = 0; o < p.n_ops && !rule_drop; ++o) {
      const OpDesc& op = p.ops[o];
      bool m = true;
      for (int q = 0; q < op.n_rules && m; ++q) {
        m = rule_holds<kMode>(p, p.rules[op.first_rule + q], row, hkl, klen,
                              ets1);
      }
      if (!m) continue;
      if (op.op == kDelete) {
        rule_drop = true;
      } else if (op.utot == kFromNow) {
        ets2 = p.now + op.value;
      } else if (op.utot == kFromCurrent) {
        if (ets1 != 0) ets2 = ets1 + op.value;
      } else {
        ets2 = op.value;
      }
    }
  }
  if (validate) {
    const uint32_t lo = kMode == kKeyHash && live && valid
                            ? key_hash_lo(row, p.k, klen, hkl, tab)
                            : hlo;
    stale = (lo & p.pv) != owner;
    if ((p.flags & kSlotGate) && stale && live) {
      stale = p.slot_allowed[owner_at] != 0;
    }
  }
  const bool expired = (p.flags & kExpire) && ets2 > 0 && ets2 <= p.now;
  const bool drop = (live && valid && (expired || stale)) || rule_drop;

  if ((p.flags & kWantEts) && live) p.ets_out[b] = ets2;
  if (!(p.flags & kPack)) {
    if (live) p.drop_out[b] = drop;
    return;
  }
  const unsigned bits = __ballot_sync(0xFFFFFFFFu, drop);
  // base + (r & ~31): the warp's first row
  write_packed(bits, base + (r & ~31), p.n, p.drop_out);
}

// One block a tile. Only the key-hash instance carries the crc64 loop
// and its tables, staged in shared memory (its block's one barrier).
template <int kMode>
__global__ void __launch_bounds__(kTile, kMinBlocksPerSm)
    compaction_filter_kernel(const __grid_constant__ Params p) {
  __shared__ __align__(16) unsigned long long tab[kMode == kKeyHash
                                                       ? kCrcWords
                                                       : 2];
  if (kMode == kKeyHash) {
    stage_crc_tables(tab, p.crc_tab);
    __syncthreads();
  }
  filter_tile<kMode>(p, blockIdx.x, tab);
}

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kGateRows = kTile * 8;  // rows a slot-gate block covers

// 8 bool bytes (row m in byte m) -> one byte, row m at bit 7 - m
// (jnp.packbits' order): byte m times 2^k lands at bit 56 + k for
// k = 7 - m, and no two partial products share a bit.
__device__ __forceinline__ uint32_t pack_bools(uint2 v) {
  const unsigned long long x =
      (static_cast<unsigned long long>(v.y) << 32) | v.x;
  return static_cast<uint32_t>((x * 0x8040201008040201ull) >> 56);
}

// 4 rows of the TTL pass: the default-TTL rewrite into `ets`, and the
// rows to drop before `valid` (expired, or stale in an allowed slot), the
// first row at bit 3
__device__ __forceinline__ uint32_t gate_nibble(uint4& ets, uint4 lo,
                                                uint32_t owner, bool allowed,
                                                uint32_t now, uint32_t ttl,
                                                uint32_t pv) {
  uint32_t e[4] = {ets.x, ets.y, ets.z, ets.w};
  const uint32_t h[4] = {lo.x, lo.y, lo.z, lo.w};
  uint32_t nib = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (ttl != 0 && e[q] == 0) e[q] = now + ttl;
    const bool expired = e[q] > 0 && e[q] <= now;
    const bool stale = allowed && (h[q] & pv) != owner;
    nib |= static_cast<uint32_t>(expired || stale) << (3 - q);
  }
  ets = make_uint4(e[0], e[1], e[2], e[3]);
  return nib;
}

__global__ void __launch_bounds__(kTile)
    slot_gate_kernel(const uint32_t* __restrict__ expire_ts,
                     const uint8_t* __restrict__ valid,
                     const uint32_t* __restrict__ hash_lo,
                     const uint32_t* __restrict__ slot_pidx,
                     const uint8_t* __restrict__ slot_allowed, int64_t n,
                     int slot_shift, uint32_t now, uint32_t default_ttl,
                     uint32_t pv, uint8_t* __restrict__ drop_out,
                     uint32_t* __restrict__ ets_out) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kGateRows;
  const int64_t tr = first + (threadIdx.x >> 5) * 256;  // the warp's rows
  const int64_t ra = tr + 4 * lane;  // this lane's loads: rows ra.., rb..
  const int64_t rb = ra + 128;
  const int64_t j = (tr >> 3) + lane;  // the mask byte this lane owns

  // every load first
  uint4 ea = make_uint4(0, 0, 0, 0), eb = ea, ha = ea, hb = ea;
  if (ra < n) {
    ea = *reinterpret_cast<const uint4*>(expire_ts + ra);
    ha = *reinterpret_cast<const uint4*>(hash_lo + ra);
  }
  if (rb < n) {
    eb = *reinterpret_cast<const uint4*>(expire_ts + rb);
    hb = *reinterpret_cast<const uint4*>(hash_lo + rb);
  }
  uint2 vv = make_uint2(0, 0);
  if (j * 8 < n) vv = *reinterpret_cast<const uint2*>(valid + j * 8);
  uint32_t own_a, own_b;
  bool al_a, al_b;
  if ((int64_t{1} << slot_shift) >= kGateRows) {  // one slot a block
    const int64_t s = first >> slot_shift;
    own_a = own_b = slot_pidx[s];
    al_a = al_b = slot_allowed[s] != 0;
  } else {
    const int64_t sa = (ra < n ? ra : 0) >> slot_shift;
    const int64_t sb = (rb < n ? rb : 0) >> slot_shift;
    own_a = slot_pidx[sa];
    own_b = slot_pidx[sb];
    al_a = slot_allowed[sa] != 0;
    al_b = slot_allowed[sb] != 0;
  }

  const uint32_t nibs =
      gate_nibble(ea, ha, own_a, al_a, now, default_ttl, pv) |
      (gate_nibble(eb, hb, own_b, al_b, now, default_ttl, pv) << 4);
  if (ets_out != nullptr) {
    if (ra < n) *reinterpret_cast<uint4*>(ets_out + ra) = ea;
    if (rb < n) *reinterpret_cast<uint4*>(ets_out + rb) = eb;
  }
  // the owner's byte: rows 8 lane .. + 7 are the nibbles of lanes
  // 2 lane and 2 lane + 1, from their first load (lane < 16) or second
  const uint32_t hi = __shfl_sync(kFull, nibs, (2 * lane) & 31);
  const uint32_t lo = __shfl_sync(kFull, nibs, (2 * lane + 1) & 31);
  const uint32_t gone =
      lane < 16 ? ((hi & 0xF) << 4) | (lo & 0xF) : (hi & 0xF0) | (lo >> 4);
  if (j * 8 < n) drop_out[j] = static_cast<uint8_t>(gone & pack_bools(vv));
}

}  // namespace

// The resident image's TTL pass on `stream`: n rows (a multiple of 8) of
// P slots of 2^slot_shift rows (slot_shift >= 3), validation against
// hash_lo with the slot gate, no ruleset; returns the launch's error (0
// on success) or cudaErrorInvalidValue for arguments the kernel does not
// take. Device pointers: expire_ts and hash_lo uint32[n] (16-byte
// aligned), valid uint8[n] (8-byte aligned), slot_pidx uint32[P],
// slot_allowed uint8[P], drop_out uint8[n / 8] (packed as
// jnp.packbits), ets_out uint32[n] (16-byte aligned) or null.
extern "C" int pegasus_slot_gate_filter(
    const uint32_t* expire_ts, const uint8_t* valid, const uint32_t* hash_lo,
    const uint32_t* slot_pidx, const uint8_t* slot_allowed, int64_t n,
    int slot_shift, uint32_t now, uint32_t default_ttl, uint32_t pv,
    uint8_t* drop_out, uint32_t* ets_out, void* stream) {
  if (n < 0 || (n & 7) || slot_shift < 3 || slot_shift > 62 ||
      !expire_ts || !valid || !hash_lo || !slot_pidx || !slot_allowed ||
      !drop_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int64_t blocks = (n + kGateRows - 1) / kGateRows;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  slot_gate_kernel<<<static_cast<unsigned>(blocks), kTile, 0,
           static_cast<cudaStream_t>(stream)>>>(
      expire_ts, valid, hash_lo, slot_pidx, slot_allowed, n, slot_shift, now,
      default_ttl, pv, drop_out, ets_out);
  return static_cast<int>(cudaGetLastError());
}

// Launches one kernel over n rows on `stream` and returns
// cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take. Column and
// pattern pointers are device memory, the key rows 16-byte aligned;
// `ops` and `rules` are host arrays of n_ops OpDesc and n_rules RuleDesc,
// copied into the kernel's parameter. k is the key width, a power of two
// >= 32. `flags`: kValidate, kExpire, kWantEts, kPack, kNeedKeys (the
// kernel reads the key rows and key_len), kHashKeys (validation hashes
// the keys with the crc64 slicing tables `crc_tab`, kCrcSlices x 256
// uint64 in device memory, 16-byte aligned, instead of reading hash_lo;
// needs kNeedKeys), kSlotGate (the stale-split term also needs
// slot_allowed[row >> slot_shift], uint8 in device memory, and a non-null
// pidx_col holds one pidx a slot; with kValidate).
extern "C" int pegasus_compaction_filter(
    const uint8_t* keys, const int32_t* key_len, const uint32_t* expire_ts,
    const uint8_t* valid, const uint32_t* hash_lo, const uint32_t* pidx_col,
    uint32_t pidx, int64_t n, int k, const OpDesc* ops, int n_ops,
    const RuleDesc* rules, int n_rules, const uint8_t* pats, uint32_t now,
    uint32_t default_ttl, uint32_t pv, int flags, uint8_t* drop_out,
    uint32_t* ets_out, void* stream, const unsigned long long* crc_tab,
    const uint8_t* slot_allowed, int slot_shift) {
  if (n < 0 || k < 32 || (k & (k - 1)) || n_ops < 0 || n_ops > kMaxOps ||
      n_rules < 0 || n_rules > kMaxRules) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((flags & kHashKeys) &&
      (!(flags & kNeedKeys) || crc_tab == nullptr || keys == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((flags & kSlotGate) &&
      (!(flags & kValidate) || slot_allowed == nullptr || slot_shift < 0 ||
       slot_shift > 62)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Params p{};
  for (int i = 0; i < n_ops; ++i) {
    p.ops[i] = ops[i];
    if (ops[i].first_rule < 0 || ops[i].n_rules < 0 ||
        ops[i].first_rule + ops[i].n_rules > n_rules) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  for (int i = 0; i < n_rules; ++i) p.rules[i] = rules[i];
  p.keys = keys;
  p.key_len = key_len;
  p.expire_ts = expire_ts;
  p.valid = valid;
  p.hash_lo = hash_lo;
  p.pidx_col = pidx_col;
  p.pats = pats;
  p.crc_tab = crc_tab;
  p.slot_allowed = slot_allowed;
  p.slot_shift = slot_shift;
  p.drop_out = drop_out;
  p.ets_out = ets_out;
  p.n = n;
  p.pidx = pidx;
  p.now = now;
  p.default_ttl = default_ttl;
  p.pv = pv;
  p.k = k;
  p.k_shift = __builtin_ctz(static_cast<unsigned>(k));
  p.n_ops = n_ops;
  p.flags = flags;
  const auto kernel = (flags & kHashKeys)   ? compaction_filter_kernel<kKeyHash>
                      : (flags & kNeedKeys) ? compaction_filter_kernel<kKeyRows>
                                            : compaction_filter_kernel<kColumns>;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(tiles), kTile, 0,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
