// Compaction-filter kernel for Hopper (sm_90a): one launch over a chunk of
// padded record rows.
//
// Replaces the JAX package's fused compaction program
// pegasus_tpu/ops/compaction.py:110 `eval_block` (one XLA program per
// ruleset), with the user rules of ops/compaction_rules.py:134
// `apply_rules_ops` inside it. It is not a Pallas kernel: XLA fused that
// program on the TPU, and this kernel is its hand-written counterpart.
// The reference order of KeyWithTTLCompactionFilter::Filter
// (key_ttl_compaction_filter.h:55-121) per row b, all uint32 arithmetic
// wrapping at 2^32:
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
//   drop  = ((expire && 0 < ets2 <= now) || (validate &&
//           (hash_lo & pv) != pidx)) && valid) || rule_drop
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
// row K B and key_len 4 B when a pattern rule is present (the hashkey
// length is the row's own first two bytes, so no column carries it);
// hash_lo 4 B and a per-row pidx 4 B with validation. Output: 1/8 B a row
// packed (1 B unpacked), ets2 4 B when asked. The bulk path's chunk of
// 2^18 rows at K = 32 with rules, validation and ets2 moves 49 + 4.125 B
// a row, about 13.9 MB, about 4.2 us; BASELINE config #4's ruleset
// without validation or ets2 moves 41.125 B a row, about 10.8 MB, about
// 3.2 us. A ruleset heavy in ANYWHERE patterns over wide keys is bound by
// its match loop instead (up to K candidate starts a pattern a row).
//
// Design, against that bound (a simple, correct first design): one thread
// a row in tiles of 256 rows; every column load of the tile is issued
// before the key tile is waited on; the tile's key rows, one contiguous
// range of 256 x K bytes, are staged in shared memory with 16-byte loads
// at a row stride of K + 4 (match.cuh: stage_keys), and only when a
// pattern rule needs them; rows wider than 256 B are matched in place.
// The hashkey length comes from the staged row's first two bytes.
// The matcher is the scan kernel's (match.cuh); an operation stops at its
// first failing rule and a deleted row skips the remaining operations.
// The packed mask comes from __ballot_sync, four lanes writing a warp's
// four bytes.

#include <cstdint>
#include <cuda_runtime.h>

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

struct Params {
  OpDesc ops[kMaxOps];
  RuleDesc rules[kMaxRules];
  const uint8_t* keys;          // uint8[n, k]
  const int32_t* key_len;       // int32[n]
  const uint32_t* expire_ts;    // uint32 bits[n]
  const uint8_t* valid;         // bool[n]
  const uint32_t* hash_lo;      // uint32 bits[n]
  const uint32_t* pidx_col;     // uint32 bits[n], or null: `pidx`
  const uint8_t* pats;
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
};
static_assert(sizeof(Params) <= 4096, "kernel parameter limit");

__device__ __forceinline__ bool rule_holds(const Params& p,
                                           const RuleDesc& rd,
                                           const uint8_t* row, int hkl,
                                           int klen, uint32_t ets) {
  if (rd.kind == kHashkey || rd.kind == kSortkey) {
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

__global__ void __launch_bounds__(kTile)
    compaction_filter_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint8_t tile_keys[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t left = p.n - base;
  const int n = left < kTile ? static_cast<int>(left) : kTile;
  const int r = threadIdx.x;
  const bool live = r < n;
  const int64_t b = base + r;
  const bool validate = p.flags & kValidate;
  const bool need_keys = p.flags & kNeedKeys;

  // every column load of the tile is in flight before the key tile is
  // waited on
  const uint8_t valid = live ? p.valid[b] : 0;
  const uint32_t ets0 = live ? p.expire_ts[b] : 0;
  const uint32_t hlo = live && validate ? p.hash_lo[b] : 0;
  const uint32_t owner = p.pidx_col == nullptr
                             ? p.pidx
                             : (live && validate ? p.pidx_col[b] : 0);
  const int klen = live && need_keys ? p.key_len[b] : 0;

  const bool staged = need_keys && p.k <= kMaxStagedWidth;
  if (staged) stage_keys(p.keys, base, n, p.k, p.k_shift, tile_keys);
  const uint8_t* row =
      staged ? tile_keys + r * (p.k + 4)
             : p.keys + (static_cast<size_t>(live ? b : 0) << p.k_shift);
  // the big-endian u16 hashkey length at the head of every key row
  const int hkl = klen > 0 ? (row[0] << 8) | row[1] : 0;

  const uint32_t ets1 =
      p.default_ttl != 0 && ets0 == 0 ? p.now + p.default_ttl : ets0;
  uint32_t ets2 = ets1;
  bool rule_drop = false;
  if (live && valid) {
    for (int o = 0; o < p.n_ops && !rule_drop; ++o) {
      const OpDesc& op = p.ops[o];
      bool m = true;
      for (int q = 0; q < op.n_rules && m; ++q) {
        m = rule_holds(p, p.rules[op.first_rule + q], row, hkl, klen, ets1);
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
  const bool expired = (p.flags & kExpire) && ets2 > 0 && ets2 <= p.now;
  const bool stale = validate && (hlo & p.pv) != owner;
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

}  // namespace

// Launches one kernel over n rows on `stream` and returns
// cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take. Column and
// pattern pointers are device memory; `ops` and `rules` are host arrays of
// n_ops OpDesc and n_rules RuleDesc, copied into the kernel's parameter.
// k is the key width, a power of two >= 32. `flags`: kValidate, kExpire,
// kWantEts, kPack, kNeedKeys (a pattern rule reads the key rows and
// key_len).
extern "C" int pegasus_compaction_filter(
    const uint8_t* keys, const int32_t* key_len, const uint32_t* expire_ts, const uint8_t* valid, const uint32_t* hash_lo,
    const uint32_t* pidx_col, uint32_t pidx, int64_t n, int k,
    const OpDesc* ops, int n_ops, const RuleDesc* rules, int n_rules,
    const uint8_t* pats, uint32_t now, uint32_t default_ttl, uint32_t pv,
    int flags, uint8_t* drop_out, uint32_t* ets_out, void* stream) {
  if (n < 0 || k < 32 || (k & (k - 1)) || n_ops < 0 || n_ops > kMaxOps ||
      n_rules < 0 || n_rules > kMaxRules) {
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
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = (flags & kNeedKeys) && k <= kMaxStagedWidth;
  const size_t smem = staged ? static_cast<size_t>(kTile) * (k + 4) : 0;
  if (smem > 48 * 1024) {
    // set on every such launch: the attribute is per device, and launches
    // come from several threads
    const cudaError_t err = cudaFuncSetAttribute(
        compaction_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  compaction_filter_kernel<<<static_cast<unsigned>(tiles), kTile, smem,
                             static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
