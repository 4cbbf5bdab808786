// Scan predicate kernel for Hopper (sm_90a): one status byte per record.
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
// The wrapper (ops/fused_scan.py) derives the static keep mask, the four
// ScanMasks and the Pallas (keep, expired) pair from it.
//
// Bound on an H100 SXM (3.35 TB/s): memory. For B = 1024, K = 32 a block
// reads about 49 KB (keys 32 KB; key_len, hashkey_len, expire_ts, hash_lo
// 4 KB each; valid 1 KB; a per-record pidx column 4 KB more when given)
// and writes 1 KB: about 15 ns of memory time, far below the few
// microseconds of a launch. One launch per block is therefore
// launch-latency bound, and the server stacks the blocks of a scan window
// into one launch.
//
// Design: one thread per record, both patterns staged once per thread
// block in dynamic shared memory (any length the XLA path accepts), a
// plain loop over candidate start positions for FT_MATCH_ANYWHERE. Rows
// are read byte by byte; making the reads coalesced is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// filter types (idl/rrdb.thrift); FT_MATCH_ANYWHERE = 1 is the fall-through
constexpr int kNoFilter = 0;
constexpr int kPrefix = 2;
constexpr int kPostfix = 3;

constexpr uint8_t kPad = 0;
constexpr uint8_t kKeep = 1;
constexpr uint8_t kExpired = 2;
constexpr uint8_t kHashInvalid = 3;
constexpr uint8_t kFiltered = 4;

constexpr int kThreads = 256;

// Semantics of match_filter (ops/predicates.py): an empty pattern matches
// everything; the region must be at least as long as the pattern; PREFIX
// and POSTFIX read clip(offset + j, 0, K - 1); ANYWHERE tries starts t in
// [0, K) inside the region and reads zero bytes past K. Regions of
// malformed rows may be negative or run past the row.
__device__ bool match_region(const uint8_t* row, int k, int start, int len,
                             const uint8_t* pat, int plen, int ftype) {
  if (ftype == kNoFilter || plen == 0) return true;
  if (len < plen) return false;
  if (ftype == kPrefix || ftype == kPostfix) {
    const int offs = ftype == kPrefix ? start : start + len - plen;
    for (int j = 0; j < plen; ++j) {
      const int idx = min(max(offs + j, 0), k - 1);
      if (row[idx] != pat[j]) return false;
    }
    return true;
  }
  const int t_end = min(start + len - plen, k - 1);
  for (int t = max(start, 0); t <= t_end; ++t) {
    bool ok = true;
    for (int j = 0; j < plen && ok; ++j) {
      const int pos = t + j;
      ok = (pos < k ? row[pos] : 0) == pat[j];
    }
    if (ok) return true;
  }
  return false;
}

__global__ void scan_predicate_kernel(
    const uint8_t* __restrict__ keys, const int32_t* __restrict__ key_len,
    const int32_t* __restrict__ hashkey_len,
    const uint32_t* __restrict__ expire_ts, const uint8_t* __restrict__ valid,
    const uint32_t* __restrict__ hash_lo,
    const uint32_t* __restrict__ pidx_col,
    uint32_t pidx, uint32_t pv, int validate, int hft,
    const uint8_t* __restrict__ hpat, int hplen, int sft,
    const uint8_t* __restrict__ spat, int splen, int has_now, uint32_t now,
    uint8_t* __restrict__ out, int n, int k) {
  extern __shared__ uint8_t pats[];
  for (int i = threadIdx.x; i < hplen + splen; i += blockDim.x) {
    pats[i] = i < hplen ? hpat[i] : spat[i - hplen];
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  if (!valid[b]) {
    out[b] = kPad;
    return;
  }
  const uint32_t ets = expire_ts[b];
  if (has_now && ets > 0 && ets <= now) {
    out[b] = kExpired;
    return;
  }
  if (validate) {
    const uint32_t owner = pidx_col != nullptr ? pidx_col[b] : pidx;
    if ((hash_lo[b] & pv) != owner) {
      out[b] = kHashInvalid;
      return;
    }
  }
  const uint8_t* row = keys + static_cast<size_t>(b) * k;
  const int hkl = hashkey_len[b];
  const bool ok =
      match_region(row, k, 2, hkl, pats, hplen, hft) &&
      match_region(row, k, 2 + hkl, key_len[b] - 2 - hkl, pats + hplen,
                   splen, sft);
  out[b] = ok ? kKeep : kFiltered;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success). Every pointer is device memory; pidx_col may be null (then the
// scalar pidx applies to every record). hplen/splen count pattern bytes
// (0 for FT_NO_FILTER).
extern "C" int pegasus_scan_predicate(
    const uint8_t* keys, const int32_t* key_len, const int32_t* hashkey_len,
    const uint32_t* expire_ts, const uint8_t* valid, const uint32_t* hash_lo,
    const uint32_t* pidx_col, uint32_t pidx, uint32_t pv, int validate,
    int hft, const uint8_t* hpat, int hplen, int sft, const uint8_t* spat,
    int splen, int has_now, uint32_t now, uint8_t* out, int n, int k,
    void* stream) {
  if (n == 0) return 0;
  const size_t smem = static_cast<size_t>(hplen) + splen;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scan_predicate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  scan_predicate_kernel<<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      keys, key_len, hashkey_len, expire_ts, valid, hash_lo, pidx_col, pidx,
      pv, validate, hft, hpat, hplen, sft, spat, splen, has_now, now, out, n,
      k);
  return static_cast<int>(cudaGetLastError());
}
